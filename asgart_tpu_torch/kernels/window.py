"""KG ``offset_slots``: a trim window's suffix order into genome positions.

Kernel: ``csrc/window.cu`` (see its header for what it replaces in the
JAX package and how it is bounded). ``offset_slots_plain`` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import torch

from . import _build


def offset_slots(sa: torch.Tensor, ws: int) -> torch.Tensor:
    """``sa += ws`` over every slot of ``sa`` (int32, contiguous), in
    place; returns ``sa``. The caller keeps ``sa + ws`` inside int32."""
    if sa.dtype != torch.int32 or not sa.is_contiguous():
        raise ValueError("offset_slots: sa must be contiguous int32")
    if not 0 <= ws < 2**31:
        raise ValueError(f"offset_slots: bad window start {ws}")
    if not _build.on_cuda(sa):
        return offset_slots_plain(sa, ws)
    if sa.numel() == 0:
        return sa
    lib = _build.lib()
    offset_slots.launches += 1
    _build.check(lib.asgart_offset_slots(sa.data_ptr(), sa.numel(), ws,
                                         _build.stream_of(sa)),
                 "offset_slots")
    return sa


offset_slots.launches = 0


def offset_slots_plain(sa: torch.Tensor, ws: int) -> torch.Tensor:
    """Plain PyTorch version of the KG kernel."""
    return sa.add_(ws)
