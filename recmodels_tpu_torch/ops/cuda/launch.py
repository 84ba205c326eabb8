"""What every kernel wrapper checks before it hands pointers to the C side."""

from __future__ import annotations

import torch


def cuda_device(t: torch.Tensor, what: str) -> torch.device:
    """The tensor's device, which must be CUDA for a kernel launch."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device


def require(what: str, t: torch.Tensor, dtypes, ndim: int, device: torch.device,
            align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` of one of
    ``dtypes`` with ``ndim`` dimensions, whose data starts on an ``align``-
    byte boundary (the kernels read with vector loads)."""
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: data not {align}-byte aligned")


def device_and_stream(device: torch.device) -> tuple[int, int]:
    """(device index, handle of PyTorch's current stream on it)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream
