"""NVIDIA H100 SXM5 constants: the denominators of the port's roofline.

The counterpart of :mod:`repro.roofline.hw`, which holds TPU v5e numbers;
no TPU number enters this module.  The peaks are NVIDIA's data sheet for
the SXM part at its full 700 W power limit (dense rates, no sparsity), as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reports
the card the port is measured on: ``NVIDIA H100 80GB HBM3, 700.00 W``.  A
card set below 700 W runs slower under load; state a roofline share with
the card's power limit beside it.

The L2 size is read from the card (:func:`l2_bytes`), not kept here.
"""

from __future__ import annotations

HBM_BW = 3.35e12               # bytes/s of device memory (HBM3)
PEAK_FLOPS_F32 = 67e12         # float32 outside the tensor cores (FFMA)
PEAK_FLOPS_TF32 = 494.7e12     # TF32 on the tensor cores, dense
PEAK_FLOPS_BF16 = 989.4e12     # bf16 and fp16 on the tensor cores, dense
NVLINK_BW = 450e9              # bytes/s a direction, NVLink 4 (18 links)
HBM_BYTES = 80 * 10**9         # 80 GB of device memory

#: Bytes an element, keyed by the torch dtype's name (``str(dtype)``
#: without its ``torch.`` prefix).
DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int64": 8, "uint64": 8, "int32": 4, "uint32": 4,
    "int16": 2, "uint16": 2, "int8": 1, "uint8": 1, "bool": 1,
    "complex64": 8, "complex128": 16,
}


def l2_bytes(device=0) -> int:
    """The L2 cache size of a CUDA ``device``, as the card reports it
    (50 MB on an H100 SXM5)."""
    import torch

    return torch.cuda.get_device_properties(device).L2_cache_size
