"""KT ``gather_owned``: one rank's share of the rank-sharded window
engine's match gather.

Kernel: ``csrc/sharded.cu`` (see its header for what it replaces in the
JAX package and how it is bounded). ``gather_owned_plain`` is the same
function in plain PyTorch: a ``repeat_interleave`` and a masked
``index_select``.
"""

from __future__ import annotations

import torch

from . import _build


def csr_offsets(lane_lo: torch.Tensor, lane_hi: torch.Tensor,
                lane_mask: torch.Tensor, total: int | None = None
                ) -> tuple[torch.Tensor, int]:
    """(off int64 [n], total): each masked lane's exclusive offset in the
    flat buffer of all masked lanes' windows, and that buffer's length.
    A caller that holds the exact length passes it as ``total``, and the
    length is not read back from the card."""
    cnt = torch.where(lane_mask, lane_hi - lane_lo, 0).to(torch.int64)
    csum = torch.cumsum(cnt, 0)
    if total is None:
        total = int(csum[-1]) if csum.numel() else 0
    return csum - cnt, total


def gather_owned(lane_lo: torch.Tensor, lane_hi: torch.Tensor,
                 lane_mask: torch.Tensor, off: torch.Tensor, total: int,
                 sa_local: torch.Tensor, row0: int) -> torch.Tensor:
    """int32 [total]: for every masked lane l and t < lane_hi[l] -
    lane_lo[l], ``flat[off[l] + t] = sa_local[lane_lo[l] + t - row0]``
    where that row lies in this rank's rows [row0, row0 +
    len(sa_local)), else 0. ``off`` and ``total`` are
    :func:`csr_offsets`' (windows are global rows of the window's suffix
    order; masked-out lanes are skipped)."""
    n = lane_lo.numel()
    for t, dt in ((lane_lo, torch.int32), (lane_hi, torch.int32),
                  (lane_mask, torch.bool), (off, torch.int64),
                  (sa_local, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("gather_owned: bad dtype or layout")
    if lane_hi.numel() != n or lane_mask.numel() != n or off.numel() != n:
        raise ValueError("gather_owned: lane arrays differ in length")
    # KD's lane bounds over the gathered buffer are int32
    if not 0 <= total < 2**31:
        raise ValueError(f"gather_owned: {total} entries are beyond int32 "
                         "lane bounds")
    if row0 < 0:
        raise ValueError(f"gather_owned: bad first row {row0}")
    if not _build.on_cuda(lane_lo, lane_hi, lane_mask, off, sa_local):
        return gather_owned_plain(lane_lo, lane_hi, lane_mask, off, total,
                                  sa_local, row0)
    flat = torch.empty(total, dtype=torch.int32, device=lane_lo.device)
    if total == 0:
        return flat
    lib = _build.lib()
    gather_owned.launches += 1
    _build.check(lib.asgart_gather_owned(
        lane_lo.data_ptr(), lane_hi.data_ptr(), lane_mask.data_ptr(),
        off.data_ptr(), n, sa_local.data_ptr(), row0, sa_local.numel(),
        flat.data_ptr(), _build.stream_of(lane_lo)), "gather_owned")
    return flat


gather_owned.launches = 0


def gather_owned_plain(lane_lo, lane_hi, lane_mask, off, total, sa_local,
                       row0) -> torch.Tensor:
    """Plain PyTorch version of the KT kernel."""
    dev = sa_local.device
    cnt = torch.where(lane_mask, lane_hi - lane_lo, 0).to(torch.int64)
    lane = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev),
                                   cnt, output_size=total)
    row = (lane_lo.to(torch.int64)[lane] - off[lane] - row0
           + torch.arange(total, device=dev))
    own = (row >= 0) & (row < sa_local.numel())
    flat = torch.zeros(total, dtype=torch.int32, device=dev)
    flat[own] = sa_local.index_select(0, row[own])
    return flat
