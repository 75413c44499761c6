"""KC ``invert_fused``: rank, lane windows and per-chunk totals.

Kernel: ``csrc/invert.cu`` (a partitioned scatter: two partition passes
and a fill of shared-memory tiles; its scratch is :func:`kc_plan`; the
chunks' lane offsets go in the launch by value up to ``KC_OFF_CAPACITY``
chunks). ``invert_fused_plain`` is the same function in plain PyTorch.
KJ ``invert_tables`` (:mod:`.tables`) is the same scatter's table form,
its scratch :func:`kc_plan` with no direct row.
"""

from __future__ import annotations

import array
from typing import NamedTuple

import torch

from . import _build


# csrc/invert.cu: the chunks whose lane offsets go in the launch by value
# (kOffCap); log2 of the destinations of a bucket of the first partition
# pass (kCoarse: below 2^31 rows, at most 1024 buckets) and of a tile of
# the second, which one block fills in shared memory (kTile)
KC_OFF_CAPACITY = 256
KC_COARSE = 21
KC_TILE = 13


class KcPlan(NamedTuple):
    """KC's scratch, one int32 buffer of ``words``: first the cursors of
    the ``coarse`` buckets and then of the ``tiles``; each
    partition pass's planes, dest and run_lo of M slots at ``d1_at``,
    ``l1_at`` (``d2_at``, ``l2_at``) and, with probe rows (M > W), run_hi
    at ``h1_at`` (``h2_at``; 0: none) of the slots from ``h1_first``
    (``h2_first``), the first slot of the bucket (tile) that holds W, to
    M; each plane 16-byte aligned."""

    coarse: int
    tiles: int
    d1_at: int
    l1_at: int
    h1_at: int
    h1_first: int
    d2_at: int
    l2_at: int
    h2_at: int
    h2_first: int
    words: int


def kc_plan(M: int, W: int) -> KcPlan:
    """The partitioned scatter of ``M`` rows, ``W`` of them direct: its
    buckets, tiles and scratch layout."""
    if M >= 1 << 31:
        raise ValueError(f"invert_fused: {M} rows pass int32 addressing")

    def up(x):
        return -(-x // 4) * 4

    coarse = -(-M // (1 << KC_COARSE))
    tiles = -(-M // (1 << KC_TILE))
    at = up(coarse + tiles)
    planes = []
    for shift in (KC_COARSE, KC_TILE):
        first = W >> shift << shift
        d, lo = at, at + up(M)
        at = lo + up(M)
        hi = at if M > W else 0
        at += up(M - first) if M > W else 0
        planes.append((d, lo, hi, first if M > W else 0))
    return KcPlan(coarse, tiles, *planes[0], *planes[1], at)


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
    if M == 0:  # no row, every chunk empty
        return rank, lane_lo, lane_hi, totals.zero_()[:n_chunks]
    plan = kc_plan(M, W)
    scratch = torch.empty(plan.words, dtype=torch.int32, device=dev)
    sp = scratch.data_ptr()

    def at(words):  # a plane's address, None for no plane
        return sp + 4 * words if words else None

    off = array.array("q", lane_off)
    cap = KC_OFF_CAPACITY if n_chunks <= KC_OFF_CAPACITY else 0
    if cap:
        off_ptr = off.buffer_info()[0]
    else:  # the table form: the offsets on the card
        off = torch.frombuffer(off, dtype=torch.int64).to(dev)
        off_ptr = off.data_ptr()
    lib = _build.lib()
    invert_fused.launches += 1
    _build.check(lib.asgart_invert_fused(
        sa.data_ptr(), run_lo.data_ptr(), run_hi.data_ptr(),
        lane_mask.data_ptr(), M, W, off_ptr, n_chunks, cap, sp, plan.coarse,
        plan.tiles, at(plan.d1_at), at(plan.l1_at), at(plan.h1_at),
        plan.h1_first, at(plan.d2_at), at(plan.l2_at), at(plan.h2_at),
        plan.h2_first, rank.data_ptr(), lane_lo.data_ptr(),
        lane_hi.data_ptr(), totals.data_ptr(), _build.stream_of(sa)),
        "invert_fused")
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
