"""Assigned input-shape grid.

40 cells = 10 archs × 4 shapes, as the JAX package's
``repro/configs/shapes.py`` names them.  ``decode_*`` / ``long_*`` serve one
new token against a seq_len-sized cache; ``long_500k`` runs only for the
sub-quadratic archs (DESIGN.md §5) — the pure full-attention archs record a
documented skip.  ``input_specs`` waits for the port's dry run.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

#: archs with a sub-quadratic long-context mechanism (DESIGN.md §5)
LONG_CONTEXT_OK = {
    "rwkv6-3b",       # O(1) recurrent state
    "zamba2-7b",      # SSM states + 13 shared-attn caches
    "gemma3-1b",      # 5/6 layers local (window 512)
    "mixtral-8x7b",   # SWA rolling ring (window 4096)
}


def cell_runnable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_OK:
        return False, ("skipped: pure full-attention arch has no "
                       "sub-quadratic long-context mechanism (DESIGN.md §5)")
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs.base import list_archs

    return [(a, s) for a in list_archs() for s in SHAPES]
