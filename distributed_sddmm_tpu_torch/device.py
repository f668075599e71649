"""Device choice and the CUDA probe (counterpart of ``utils/platform.py``
and ``compat.py``).

Every entry point resolves its ``device`` argument here: the default is
``cuda``, and asking for CUDA where there is none raises instead of
falling back to the CPU. Resolving a device also pins TF32 off, so float32
matrix products and convolutions run in full float32, as the reference
results they are compared with do.
"""

from __future__ import annotations

import torch


def cuda_available() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def pin_tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` for a CUDA device
    when CUDA is unavailable, and ``ValueError`` for any other type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not cuda_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    pin_tf32_off()
    return dev


def device_label(dev: torch.device) -> str:
    """Human-readable name of the device a result came from."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def synchronize(dev: torch.device) -> None:
    """Wait for queued work on ``dev`` (no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
