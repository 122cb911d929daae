"""Device choice for the port's entry points and kernel wrappers.

A dry run (``launch.dryrun``) traces the card's program on fake tensors
(``torch._subclasses.fake_tensor``): shapes, dtypes and devices, no data.
Where torch has a CUDA build they are fake CUDA tensors. A CPU-only build
cannot differentiate through fake CUDA tensors (its autograd asks for the
CUDA device's streams and aborts), so there the trace makes fake CPU
tensors inside ``card_standin``, which stand for the card: the ops route
them to the kernel wrappers (``runs_plain`` is False), and the wrappers
take the card's route for them (``on_card``, ``address``, ``sm_count``).
"""
from __future__ import annotations

import contextlib
import functools

import torch

#: streaming multiprocessors of an NVIDIA H100 SXM: what a traced tensor's
#: routes read where no card is present
H100_SMS = 132

_STANDIN = [False]


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


def traced(t: torch.Tensor) -> bool:
    """Whether `t` is a fake tensor of a trace: it has a shape, a dtype and
    a device, and no data."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def card_standin():
    """Within the block a traced CPU tensor stands for a tensor on the card
    (see the module's note). Real tensors are unaffected."""
    before = _STANDIN[0]
    _STANDIN[0] = True
    try:
        yield
    finally:
        _STANDIN[0] = before


def on_card(t: torch.Tensor) -> bool:
    """Whether `t` is on the card, or is a traced tensor standing for one."""
    return t.device.type == "cuda" or (_STANDIN[0] and traced(t))


def runs_plain(t: torch.Tensor) -> bool:
    """Kernel-wrapper dispatch: True for a CPU tensor (the plain version
    runs), False for a CUDA tensor (the kernel runs) and for a traced
    tensor standing for one. Any other device raises."""
    if on_card(t):
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no kernel or plain version for a {t.device.type} "
                     "tensor; use a cpu or cuda tensor")


def address(t: torch.Tensor) -> int:
    """The device address of `t`'s first element, for the kernels' alignment
    rules. A traced tensor has none: its storage's base counts as aligned,
    as the card's allocator aligns every block (to 512 bytes), so its
    address is its offset into the storage."""
    if traced(t):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


@functools.cache
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of `t`'s card; ``H100_SMS`` for a traced
    tensor where no card is present."""
    if t.device.type != "cuda" or not torch.cuda.is_available():
        return H100_SMS
    return _card_sms(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())
