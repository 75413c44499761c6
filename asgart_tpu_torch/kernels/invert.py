"""KC ``invert_fused``: rank, lane windows and per-chunk totals.

Kernel: ``csrc/invert.cu``. ``invert_fused_plain`` is the same function in
plain PyTorch.
"""

from __future__ import annotations

import torch

from . import _build


def invert_fused(sa: torch.Tensor, run_lo: torch.Tensor,
                 run_hi: torch.Tensor, lane_mask: torch.Tensor, W: int,
                 lane_off: list[int]):
    """Scatter the slot-indexed run bounds to their rows: ``rank[sa] =
    run_lo`` for direct rows (sa < W), ``lane_lo/hi[sa - W] = run_lo/hi``
    for probe rows; ``sa`` must be a permutation of [0, M).
    ``lane_off`` = each chunk's first lane plus the end (n_chunks + 1
    ascending ints).

    Returns (rank int32 [W], lane_lo int32 [M - W], lane_hi int32 [M - W],
    totals int64 [n_chunks]) — totals are the exact sums of
    (lane_hi - lane_lo) over each chunk's masked lanes."""
    M = sa.numel()
    total = M - W
    n_chunks = len(lane_off) - 1
    if lane_mask.numel() != total or lane_off[0] != 0 \
            or lane_off[-1] > total:
        raise ValueError("invert_fused: lane arrays do not match sa")
    for t, dt in ((sa, torch.int32), (run_lo, torch.int32),
                  (run_hi, torch.int32), (lane_mask, torch.bool)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("invert_fused: bad dtype or layout")
    if not _build.on_cuda(sa, run_lo, run_hi, lane_mask):
        return invert_fused_plain(sa, run_lo, run_hi, lane_mask, W,
                                  lane_off)
    dev = sa.device
    rank = torch.empty(W, dtype=torch.int32, device=dev)
    lane_lo = torch.empty(total, dtype=torch.int32, device=dev)
    lane_hi = torch.empty(total, dtype=torch.int32, device=dev)
    totals = torch.empty(max(n_chunks, 1), dtype=torch.int64, device=dev)
    off_t = torch.tensor(lane_off, dtype=torch.int64, device=dev)
    lib = _build.lib()
    invert_fused.launches += 1
    _build.check(lib.asgart_invert_fused(
        sa.data_ptr(), run_lo.data_ptr(), run_hi.data_ptr(),
        lane_mask.data_ptr(), M, W, off_t.data_ptr(), n_chunks,
        rank.data_ptr(), lane_lo.data_ptr(), lane_hi.data_ptr(),
        totals.data_ptr(), _build.stream_of(sa)), "invert_fused")
    return rank, lane_lo, lane_hi, totals[:n_chunks]


invert_fused.launches = 0


def invert_fused_plain(sa, run_lo, run_hi, lane_mask, W, lane_off):
    """Plain PyTorch version of the KC kernel."""
    dev = sa.device
    total = sa.numel() - W
    direct = sa < W
    rank = torch.empty(W, dtype=torch.int32, device=dev)
    rank[sa[direct].long()] = run_lo[direct]
    probe = ~direct
    lanes = (sa[probe] - W).long()
    lane_lo = torch.empty(total, dtype=torch.int32, device=dev)
    lane_hi = torch.empty(total, dtype=torch.int32, device=dev)
    lane_lo[lanes] = run_lo[probe]
    lane_hi[lanes] = run_hi[probe]
    counts = torch.where(lane_mask, lane_hi - lane_lo, 0).to(torch.int64)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(counts, 0)])
    off = torch.tensor(lane_off, dtype=torch.int64, device=dev)
    return rank, lane_lo, lane_hi, csum[off[1:]] - csum[off[:-1]]
