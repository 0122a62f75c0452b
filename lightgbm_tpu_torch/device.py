"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA card; ``'cpu'`` selects the plain PyTorch
    versions of the kernels.  Raises when a CUDA device is asked for (or
    implied) and none is present — the port never drops to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbm_tpu_torch needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions instead"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
