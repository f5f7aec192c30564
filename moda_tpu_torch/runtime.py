"""Device selection for the entry points.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no such request they raise instead of
falling back to the CPU on their own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "moda_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain path on the CPU")
        # fp32 products outside the kernels (cost matrix, Sinkhorn, skinning
        # quadratic form) run in full fp32, as the JAX reference's HIGHEST
        # precision products do; TF32 would keep ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
