"""One rank's vote of a trip of the sharded matrix-free chain (kernel B5's
vote entry through its plain twin, ``chain_vote_plain``) against the JAX
package's per-shard vote.

The reference computes the vote inside its sharded trip
(``repro.core.distributed``): the rank's slice of the tip's row
(``repro.kernels.pairwise.row_sq_euclidean``, jnp or the Pallas kernel in
interpret mode), ``repro.core.nnchain.summary_distance``, dead slots and
the tip masked to +inf, the minimum and its first local slot, and prev's
masked value (+inf off the rank).  The same inputs, made with numpy, go
through both: slots equal, values within rtol 1e-5 / atol 1e-6.  The CUDA
kernel against the plain twin is in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import _first_where  # noqa: E402
from repro.core.nnchain import summary_distance as jsummary_distance  # noqa: E402
from repro.kernels.pairwise import row_sq_euclidean as jrow_sq  # noqa: E402
from repro_torch.core.nnchain import POINTS_METHODS  # noqa: E402
from repro_torch.kernels import pairwise  # noqa: E402

RANKS, ROWS, D = 4, 13, 6       # four blocks of 13 slots; the last holds 5 padding slots
N = RANKS * ROWS - 5            # the real points
RTOL, ATOL = 1e-5, 1e-6
BLOCK_N = 128                   # the Pallas row's tile


def chain_state(method, seed=0):
    """A mid-run state as the sharded chain holds it: summaries of whole
    clusters (sizes above 1, ``u >= 0`` for average and weighted), merged
    slots dead with size 0, padding slots past ``N`` born dead."""
    rng = np.random.default_rng(seed)
    n_pad = RANKS * ROWS
    W = np.zeros((n_pad, D), np.float32)
    W[:N] = rng.normal(size=(N, D))
    sizes = np.zeros(n_pad, np.float32)
    sizes[:N] = rng.integers(1, 9, N)
    alive = np.arange(n_pad) < N
    alive[[4, 17, 30]] = False                       # merged into another slot
    sizes[~alive] = 0.0
    u = np.zeros(n_pad, np.float32)
    if method != "ward":
        u[alive] = rng.uniform(0.0, 0.5, alive.sum())
    return W, u, sizes, alive


def jax_vote(method, W, u, sizes, alive, top, prev, rank, pallas=False):
    """The reference's per-shard vote (``repro/core/distributed.py``, its
    trip): (local min, first local slot, prev's masked value)."""
    offset = rank * ROWS
    W_loc = jnp.asarray(W[offset:offset + ROWS])
    tip = jnp.asarray(W[top])
    if pallas:          # the kernel's padding contract: d a multiple of 128, rows of BLOCK_N
        pad = jnp.zeros((BLOCK_N, 128), jnp.float32)
        sq = jrow_sq(pad[0].at[:D].set(tip), pad.at[:ROWS, :D].set(W_loc), use_pallas=True,
                     block_n=BLOCK_N, interpret=True)[:ROWS]
    else:
        sq = jrow_sq(tip, W_loc)
    mine = slice(offset, offset + ROWS)
    local_ids = offset + jnp.arange(ROWS)
    dloc = jsummary_distance(method, sq, jnp.asarray(u[mine]), jnp.float32(u[top]),
                             jnp.asarray(sizes[mine]), jnp.float32(sizes[top]))
    masked = jnp.where(jnp.asarray(alive[mine]) & (local_ids != top), dloc, jnp.inf)
    lmin = jnp.min(masked)
    larg = _first_where(masked == lmin, jnp.arange(ROWS), ROWS)
    own = prev is not None and offset <= prev < offset + ROWS
    pval = masked[prev - offset] if own else jnp.float32(jnp.inf)
    return float(lmin), int(larg), float(pval)


def torch_vote(method, W, u, sizes, alive, top, prev, rank, vote=pairwise.chain_vote):
    offset = rank * ROWS
    buf = pairwise.vote_buffers("cpu")
    out = vote(method, torch.tensor(W[top]), torch.tensor(W[offset:offset + ROWS]),
               torch.tensor(u), torch.tensor(sizes), torch.tensor(alive), top, prev, offset, buf)
    assert out.data_ptr() == buf.out.data_ptr() and out.dtype == torch.float32
    lmin, larg, pval = out.tolist()
    return lmin, int(larg), pval


def assert_vote_close(got, want, slot=True):
    np.testing.assert_allclose([got[0], got[2]], [want[0], want[2]], rtol=RTOL, atol=ATOL)
    if slot:
        assert got[1] == want[1]


def slot_on(rank, k):
    return rank * ROWS + k


def slot_off(rank, k):
    return ((rank + 1) % RANKS) * ROWS + k


@pytest.mark.parametrize("method", POINTS_METHODS)
@pytest.mark.parametrize("rank", (0, 1, RANKS - 1))
@pytest.mark.parametrize("tip", ("on", "off"))
@pytest.mark.parametrize("prev", ("on", "off", "none"))
def test_vote_matches_reference(method, rank, tip, prev):
    """Blocks at offset 0, in the middle and last (with its padding
    slots), the tip and prev on and off the rank, prev absent: the jnp
    route's vote."""
    W, u, sizes, alive = chain_state(method, seed=rank)
    top = slot_on(rank, 2) if tip == "on" else slot_off(rank, 2)
    p = {"on": slot_on(rank, 7), "off": slot_off(rank, 9), "none": None}[prev]
    want = jax_vote(method, W, u, sizes, alive, top, p, rank)
    got = torch_vote(method, W, u, sizes, alive, top, p, rank)
    assert_vote_close(got, want)
    assert (got[2] == np.inf) == (prev != "on")


@pytest.mark.parametrize("method", POINTS_METHODS)
@pytest.mark.parametrize("rank", (0, RANKS - 1))
def test_vote_matches_pallas_route(method, rank):
    """The reference's vote with its row from the Pallas kernel in
    interpret mode (Gram form)."""
    W, u, sizes, alive = chain_state(method, seed=10 + rank)
    top, p = slot_on(rank, 3), slot_off(rank, 5)
    got = torch_vote(method, W, u, sizes, alive, top, p, rank)
    assert_vote_close(got, jax_vote(method, W, u, sizes, alive, top, p, rank, pallas=True))


@pytest.mark.parametrize("method", POINTS_METHODS)
def test_vote_ties_go_to_the_first_slot(method):
    """Two slots at exactly the least distance: the first wins; prev on
    the second carries the same value as the minimum (the host's merge
    test)."""
    rank = 1
    W, u, sizes, alive = chain_state(method, seed=3)
    top = slot_off(rank, 1)
    for k in (3, 8):
        W[slot_on(rank, k)] = W[top] + np.float32(0.125)
        sizes[slot_on(rank, k)] = 2.0
        u[slot_on(rank, k)] = 0.0
    p = slot_on(rank, 8)
    want = jax_vote(method, W, u, sizes, alive, top, p, rank)
    got = torch_vote(method, W, u, sizes, alive, top, p, rank)
    assert_vote_close(got, want)
    assert got[1] == 3 and got[0] == got[2]


@pytest.mark.parametrize("method", POINTS_METHODS)
def test_vote_nan_row(method):
    """A NaN in a live slot of the block makes the minimum NaN, as in the
    reference; prev's value stays its own."""
    rank = 2
    W, u, sizes, alive = chain_state(method, seed=4)
    W[slot_on(rank, 6), 2] = np.nan
    top, p = slot_off(rank, 0), slot_on(rank, 10)
    want = jax_vote(method, W, u, sizes, alive, top, p, rank)
    got = torch_vote(method, W, u, sizes, alive, top, p, rank)
    assert np.isnan(got[0]) and np.isnan(want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)


def test_vote_dead_block_gives_inf_at_slot_0():
    """A block whose slots are all dead votes (+inf, 0, +inf), as
    ``torch.min`` of an all-inf row."""
    W, u, sizes, alive = chain_state("ward")
    alive[ROWS:2 * ROWS] = False
    got = torch_vote("ward", W, u, sizes, alive, 0, None, 1)
    assert got == (np.inf, 0, np.inf)
    assert_vote_close(got, jax_vote("ward", W, u, sizes, alive, 0, None, 1))


@pytest.mark.parametrize("method", POINTS_METHODS)
def test_plain_twin_with_the_row_entry_is_the_cpu_vote(method):
    """On the CPU the wrapper takes the plain twin (no launch), and the
    plain twin with the row entry as its row (the composition the kernel
    replaces on the card) gives the same bits."""
    W, u, sizes, alive = chain_state(method, seed=5)
    launches = pairwise.chain_vote.launches
    args = (method, W, u, sizes, alive, slot_on(1, 2), slot_on(1, 9), 1)
    got = torch_vote(*args)
    composed = torch_vote(*args, vote=lambda *a: pairwise.chain_vote_plain(
        *a, row_sq=pairwise.row_sq_euclidean))
    assert got == composed
    assert pairwise.chain_vote.launches == launches


def test_vote_rejects_bad_operands():
    W, u, sizes, alive = (torch.tensor(a) for a in chain_state("ward"))
    buf = pairwise.vote_buffers("cpu")
    block = W[:ROWS]
    with pytest.raises(ValueError, match="methods"):
        pairwise.chain_vote("complete", W[0], block, u, sizes, alive, 0, None, 0, buf)
    with pytest.raises(ValueError, match=r"\(d,\)"):
        pairwise.chain_vote("ward", W[0, :3], block, u, sizes, alive, 0, None, 0, buf)
    for top, prev, offset in ((0, None, 3 * ROWS + 1), (RANKS * ROWS, None, 0),
                              (5, RANKS * ROWS, 0), (0, -1, 0)):
        with pytest.raises(ValueError, match="out of range"):
            pairwise.chain_vote("ward", W[top % N], block, u, sizes, alive, top, prev, offset,
                                buf)
