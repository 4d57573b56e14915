"""Layer stacking and the loop over the layers.

The JAX package stacks per-layer parameters on a leading ``layers`` axis
and runs ``lax.scan`` over the stack, with remat policies for training.
The port keeps the stacked specs (:func:`stack_specs`: the reference's
parameter tree, and what ``convert`` and ``init_params`` read), holds the
layers as a ``ModuleList`` of blocks, and runs them in a Python loop
(:func:`scan_blocks`).  Remat belongs to training and waits for it.
"""

from __future__ import annotations

from typing import Callable, Iterable

from repro_torch.models.common import ParamSpec


def stack_specs(layer_specs, n_layers: int):
    """Prefix every leaf spec with a ``(n_layers,)`` ``p_layers`` axis."""
    if isinstance(layer_specs, ParamSpec):
        s = layer_specs
        return ParamSpec((n_layers,) + s.shape, ("p_layers",) + s.axes, s.init, s.scale, s.dtype)
    return {k: stack_specs(v, n_layers) for k, v in layer_specs.items()}


def scan_blocks(body: Callable, x0, xs: Iterable):
    """Run ``body(carry, xs_l) -> (carry, ys_l)`` over the layers' inputs
    ``xs`` in order.  Returns ``(final_carry, [ys_l, ...])``."""
    x, ys = x0, []
    for xs_l in xs:
        x, y = body(x, xs_l)
        ys.append(y)
    return x, ys
