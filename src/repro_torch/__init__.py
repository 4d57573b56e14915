"""repro_torch — the PyTorch/CUDA port of the Lance-Williams clustering
package ``repro``, which stays the reference it is tested against.

The port imports ``torch`` and ``numpy`` and nothing of ``jax`` or
``repro``.  Its entry points run on the CUDA device unless the caller
passes ``device="cpu"``, which runs the plain torch versions of the
kernels.
"""
