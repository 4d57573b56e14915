"""The Lance-Williams merge loop on the kernel backend, in torch.

Counterpart of :mod:`repro.core.engine`, for the loop that
``cluster(..., algorithm="lw", backend="kernel")`` runs with
``variant="baseline"``: find the global minimum, apply the recurrence,
tombstone the absorbed slot, record the merge — once per merge.  The
step is assembled from primitives (:class:`StepOps`); on the kernel
backend the candidate is seeded by the min-scan kernel and each merge is
one launch of the fused step kernel.

Storage is the *garbage* representation of the JAX engine: dead cells
keep inert values and liveness is applied at argmin time, inside the
kernels.  Merges are index-identical to the JAX package's, with heights
equal to float tolerance.

The JAX loop traces into one compiled program.  Here the loop is a
Python ``for`` over a fixed trip count, and everything a step needs
(the candidate, the merged slots, the sizes) stays on the device: no
step reads a value back to the host, so the host only enqueues launches
and the device runs ahead.  ``D`` and the merge record are updated in
place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

#: Argmin-op variants of the JAX engine; only ``baseline`` is ported.
VARIANTS: tuple[str, ...] = ("baseline", "rowmin", "lazy")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for and missing — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "none is available; pass device='cpu' to run the plain torch "
            "versions of the kernels on the CPU"
        )
    return dev


class LWResult(NamedTuple):
    """Output of a Lance-Williams run.

    merges: ``(n_steps, 4)`` float32 rows ``(i, j, dist, new_size)``, ``i < j``
        the slots merged at that step (slot ``i`` keeps the union).
    n_merges: merges recorded (``n_steps``: the loop has a fixed trip count).
    """

    merges: torch.Tensor
    n_merges: int


class LWState(NamedTuple):
    """Carry of the merge loop.

    ``D`` is the ``(n, n)`` matrix in the garbage representation, ``alive``
    the ``(n,)`` bool liveness, ``sizes`` the ``(n,)`` float32 cluster
    sizes.  ``cand`` is the next merge candidate ``(r, c, dmin)`` as 0-d
    device tensors (int64, int64, float32), computed at the tail of each
    step.  ``n_merges`` is a host int: with a fixed trip count it is known
    without asking the device.  ``cache`` is ``()`` for the baseline op.
    """

    D: torch.Tensor
    alive: torch.Tensor
    sizes: torch.Tensor
    merges: torch.Tensor
    n_merges: int
    cand: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    cache: tuple


class StepOps(NamedTuple):
    """The primitives a step is assembled from (fused tail only).

    seed:   fill ``cand`` from the initial state.
    fetch:  ``(state, ij) -> (d_ki, d_kj)``, copies of rows ``i`` and ``j``.
    commit: ``(state, ij, dmin, d_ki, d_kj, n_ij) -> (D, cand)``: applies
            the recurrence, commits the merged row and computes the next
            candidate in one matrix pass.

    The unfused ``update``/``write``/``refresh`` primitives of the JAX
    engine serve the ``lazy`` variant, which is not ported yet.
    """

    seed: Callable[[LWState], LWState]
    fetch: Callable[[LWState, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
    commit: Callable[..., tuple]


def symmetrize(D: torch.Tensor) -> torch.Tensor:
    """The single input-normalization path: accepts a full symmetric matrix
    or just its upper triangle, averages ``D`` with its transpose and zeroes
    the diagonal.  Always returns a new tensor."""
    D = torch.as_tensor(D, dtype=torch.float32)
    n = D.shape[-1]
    if D.ndim < 2 or D.shape[-2] != n:
        raise ValueError(f"distance matrix must be square, got {tuple(D.shape)}")
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    upper = torch.triu(D, diagonal=1)
    has_lower = torch.any(torch.tril(D, diagonal=-1) != 0, dim=(-2, -1), keepdim=True)
    full_sym = torch.where(has_lower, D, upper + upper.transpose(-2, -1))
    return torch.where(eye, 0.0, 0.5 * (full_sym + full_sym.transpose(-2, -1)))


def resolve_n_steps(n: int, stop_at_k: int) -> int:
    """Merge count for a run over ``n`` items stopping at ``k`` clusters."""
    if stop_at_k < 1:
        raise ValueError(f"stop_at_k must be >= 1, got {stop_at_k}")
    return max(n - stop_at_k, 0)


def make_step(ops: StepOps) -> Callable[..., LWState]:
    """Assemble the paper's merge step from primitives: candidate →
    recurrence → commit → tombstone → record → next candidate.

    ``t`` is the merge-record index (``state.n_merges`` when omitted).  The
    step writes ``D`` and ``merges`` in place and returns the new state.
    """

    def step(s: LWState, t: int | None = None) -> LWState:
        r, c, dmin = s.cand
        ij = torch.stack((torch.minimum(r, c), torch.maximum(r, c)))  # i keeps the union
        d_ki, d_kj = ops.fetch(s, ij)
        n_ij = s.sizes.index_select(0, ij)
        new_size = n_ij.sum()
        j_only = ij[1:]
        alive = s.alive.index_fill(0, j_only, False)
        sizes = s.sizes.index_fill(0, j_only, 0.0).index_put_((ij[:1],), new_size.reshape(1))
        s.merges[s.n_merges if t is None else t] = torch.cat(
            (ij.to(torch.float32), dmin.reshape(1), new_size.reshape(1))
        )
        D, cand = ops.commit(s, ij, dmin, d_ki, d_kj, n_ij)
        return LWState(D, alive, sizes, s.merges, s.n_merges + 1, cand, s.cache)

    return step


def run_merge_loop(ops: StepOps, state: LWState, n_steps: int) -> LWState:
    """Seed the candidate, then run ``n_steps`` merge trips.

    A fixed trip count: ``stop_at_k`` shrinks it on the host, and no trip
    waits for the device.  (The ``distance_threshold`` exit of the JAX
    engine is not ported yet.)
    """
    if n_steps <= 0:   # stop_at_k >= n: nothing to merge
        return state
    step = make_step(ops)
    state = ops.seed(state)
    for t in range(n_steps):
        state = step(state, t)
    return state


def _init_state(D: torch.Tensor, alive: torch.Tensor, n_steps: int) -> LWState:
    zero = torch.zeros((), dtype=torch.int64, device=D.device)
    return LWState(
        D=D,
        alive=alive,
        sizes=alive.to(torch.float32),
        merges=torch.zeros((n_steps, 4), dtype=torch.float32, device=D.device),
        n_merges=0,
        cand=(zero, zero, torch.zeros((), dtype=torch.float32, device=D.device)),
        cache=(),
    )


def _fused_ops(method: str, n: int, masked_argmin, lw_step) -> StepOps:
    """The fused baseline primitives over a min-scan and a step function
    with the signatures of :mod:`repro_torch.kernels.minscan` and
    :mod:`repro_torch.kernels.lw_step`."""

    def seed(s: LWState) -> LWState:
        v, flat = masked_argmin(s.D, s.alive)
        return s._replace(cand=(torch.div(flat, n, rounding_mode="floor"), flat % n, v))

    def fetch(s: LWState, ij: torch.Tensor):
        rows = s.D.index_select(0, ij)   # D is symmetric: rows i, j are columns i, j
        return rows[0], rows[1]

    def commit(s: LWState, ij, dmin, d_ki, d_kj, n_ij):
        D, rmin, rarg = lw_step(method, s.D, d_ki, d_kj, dmin, n_ij[0], n_ij[1],
                                s.sizes, s.alive, ij[0], ij[1])
        # the global candidate from the per-row minima: the first row that
        # attains the minimum (torch.min keeps the first), then its first
        # column — the row-major first minimum the min-scan kernel gives
        m, r = torch.min(rmin, dim=0)
        return D, (r, rarg.index_select(0, r.reshape(1)).reshape(()), m)

    return StepOps(seed=seed, fetch=fetch, commit=commit)


def kernel_ops(method: str, n: int) -> StepOps:
    """Primitives routing the seed through the min-scan kernel and every
    merge through one launch of the fused step kernel (plain torch versions
    for CPU tensors)."""
    from repro_torch.kernels.lw_step import lw_step
    from repro_torch.kernels.minscan import masked_argmin

    return _fused_ops(method, n, masked_argmin, lw_step)


def run_kernel(D: torch.Tensor, alive: torch.Tensor, *, method: str, n_steps: int) -> LWResult:
    """The merge loop over the kernel primitives.  ``D`` is updated in place;
    slots with ``alive=False`` are dead from the start."""
    n = D.shape[-1]
    out = run_merge_loop(kernel_ops(method, n), _init_state(D, alive, n_steps), n_steps)
    return LWResult(merges=out.merges, n_merges=out.n_merges)
