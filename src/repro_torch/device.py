"""Device choice for the port's entry points and kernel wrappers."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def runs_plain(t: torch.Tensor) -> bool:
    """Kernel-wrapper dispatch: True for a CPU tensor (the plain version
    runs), False for a CUDA tensor (the kernel runs). Any other device
    raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for a {t.device.type} "
                     "tensor; use a cpu or cuda tensor")
