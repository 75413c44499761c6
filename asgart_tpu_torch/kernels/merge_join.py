"""KH ``mj_ranges``: each probe lane's equal range in the sorted window keys.

Kernel: ``csrc/merge_join.cu`` (see its header for what it replaces in the
JAX package and how it is bounded). ``mj_ranges_plain`` is the same
function in plain PyTorch, by the JAX package's method: a co-sort, a
cumsum and a cummax, then a scatter back into lane order.
"""

from __future__ import annotations

import torch

from . import _build


def mj_ranges(skey: torch.Tensor, pkey: torch.Tensor,
              lane_mask: torch.Tensor, lane_off: list[int]):
    """Equal ranges of the probe keys ``pkey`` (int64 [total], KA's
    probe-only mode: flag bit 1) in the sorted window keys ``skey`` (int64
    [W], flag bit 0), keys compared without their flag bit; ``lane_off`` =
    each chunk's first lane plus the end (n_chunks + 1 ascending ints).

    Returns (lane_lo int32 [total], lane_hi int32 [total], totals int64
    [n_chunks]): lanes outside ``lane_mask`` get (0, 0); totals are the
    exact sums of (lane_hi - lane_lo) over each chunk's lanes."""
    W = skey.numel()
    total = pkey.numel()
    n_chunks = len(lane_off) - 1
    for t, dt in ((skey, torch.int64), (pkey, torch.int64),
                  (lane_mask, torch.bool)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("mj_ranges: bad dtype or layout")
    if lane_mask.numel() != total or not lane_off or lane_off[0] != 0 \
            or lane_off[-1] > total:
        raise ValueError("mj_ranges: lane arrays do not match the keys")
    if W >= 2**31:
        raise ValueError("mj_ranges: the window is beyond int32 slots")
    if not _build.on_cuda(skey, pkey, lane_mask):
        return mj_ranges_plain(skey, pkey, lane_mask, lane_off)
    dev = skey.device
    lane_lo = torch.empty(total, dtype=torch.int32, device=dev)
    lane_hi = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        return lane_lo, lane_hi, torch.zeros(n_chunks, dtype=torch.int64,
                                             device=dev)
    totals = torch.empty(max(n_chunks, 1), dtype=torch.int64, device=dev)
    off_t = torch.tensor(lane_off, dtype=torch.int64, device=dev)
    lib = _build.lib()
    mj_ranges.launches += 1
    _build.check(lib.asgart_mj_ranges(
        skey.data_ptr(), W, pkey.data_ptr(), lane_mask.data_ptr(), total,
        off_t.data_ptr(), n_chunks, lane_lo.data_ptr(), lane_hi.data_ptr(),
        totals.data_ptr(), _build.stream_of(skey)), "mj_ranges")
    return lane_lo, lane_hi, totals[:n_chunks]


mj_ranges.launches = 0


def mj_ranges_plain(skey, pkey, lane_mask, lane_off):
    """Plain PyTorch version of the KH kernel, as ``_mj_tail`` computes
    it: a stable co-sort of the window and probe keys (an equal key's
    window entries, flag 0, sort before its probes, flag 1), then per
    probe hi = the window entries at or before it (a cumsum) and lo = the
    window entries before its run's start (a cummax), scattered back into
    lane order."""
    dev = skey.device
    W, total = skey.numel(), pkey.numel()
    skeys, order = torch.sort(torch.cat([skey, pkey]), stable=True)
    probe = order >= W
    t = torch.arange(W + total, device=dev)
    cw = t + 1 - torch.cumsum(probe.to(torch.int64), 0)
    flagless = skeys >> 1
    starts = torch.ones(W + total, dtype=torch.bool, device=dev)
    starts[1:] = flagless[1:] != flagless[:-1]
    before = torch.where(starts, cw - (~probe).to(torch.int64), -1)
    wbs = torch.cummax(before, 0).values
    lanes = order[probe] - W
    lane_lo = torch.empty(total, dtype=torch.int64, device=dev)
    lane_hi = torch.empty(total, dtype=torch.int64, device=dev)
    lane_lo[lanes] = wbs[probe]
    lane_hi[lanes] = cw[probe]
    lane_lo = torch.where(lane_mask, lane_lo, 0)
    lane_hi = torch.where(lane_mask, lane_hi, 0)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(lane_hi - lane_lo, 0)])
    off = torch.tensor(lane_off, dtype=torch.int64, device=dev)
    return (lane_lo.to(torch.int32), lane_hi.to(torch.int32),
            csum[off[1:]] - csum[off[:-1]])
