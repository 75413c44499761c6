"""KD ``scan_core``: match filters and event compaction for one chunk.

Kernel: ``csrc/scan_core.cu`` (count and block sums, then one read of the
totals by the host, then emit and finish; its scratch is :func:`kd_plan`).
``scan_core_plain`` is the same function in plain PyTorch. The match
filters take three constants: :func:`fused_bases` for a suffix order of
genome positions (the fused engine), or the merge-join engine's
window-relative constants
(:func:`asgart_tpu_torch.device_engine.rebased_bases`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import _build

# the fused engine's match-position cutoff (device_engine.py:1846):
# neutral, as the JAX big-window engine's W + 1 (:2696) is for its m < W
MAX_MATCH_POS = 2**31 - 1
# lanes per block of KD's count and emit launches (csrc/scan_core.cu
# kScanThreads; the launch refuses another block count)
KD_BLOCK_LANES = 1024


@dataclass
class ScanResult:
    """One buffer ``flat`` = [ev_pack (3 x n_events, row-major) | m_flat
    (total_kept) | z_trail], so the host needs one copy."""

    flat: torch.Tensor  # int32
    n_events: int
    total_kept: int

    def to_host(self):
        """(ev_pack int32 [3, n_events], m_flat int32 [total_kept],
        z_trail int) as numpy, through one device-to-host copy."""
        flat = self.flat.cpu().numpy()
        e = 3 * self.n_events
        return (flat[:e].reshape(3, self.n_events),
                flat[e: e + self.total_kept], int(flat[-1]))


def fused_bases(chunk_start: int, chunk_len: int) -> tuple[int, int, int]:
    """The filter constants (self_base, dir_base, rev_t0) of a chunk over a
    suffix order of genome positions, as ``_scan_core`` passes them
    (asgart_tpu/device_engine.py:366-368)."""
    return 0, chunk_start, chunk_start + chunk_len


class KdPlan(NamedTuple):
    """KD's scratch, one int64 buffer of ``words``: first the block sums
    [3, blocks], the three totals at ``tot_at``, then the lanes' int32 codes
    from int64 word ``code_at``."""

    blocks: int
    tot_at: int
    code_at: int
    words: int


def kd_plan(n: int) -> KdPlan:
    """The scratch of one KD launch over ``n`` lanes."""
    blocks = -(-n // KD_BLOCK_LANES)
    tot_at = 3 * blocks
    code_at = tot_at + 3
    return KdPlan(blocks, tot_at, code_at, code_at + -(-n // 2))


def scan_core(lane_lo: torch.Tensor, lane_hi: torch.Tensor,
              lane_mask: torch.Tensor, sa: torch.Tensor, self_base: int,
              dir_base: int, rev_t0: int, max_cardinality: int, j0: int,
              k: int, reverse: bool) -> ScanResult:
    """Events and kept matches of the lanes ``lane_lo/hi/mask`` (one
    chunk's lane slice; lane l probes i = (j0 + l + 1) * (k // 2)) over
    the suffix order ``sa``: a match m is kept when m != i + self_base,
    and m > i + dir_base (direct) or m >= rev_t0 - i (reversed). The live
    prefixes of the JAX ``_scan_core`` outputs
    (asgart_tpu/device_engine.py:352) with :func:`fused_bases`, and of
    ``_scan_core_based`` (:665) with the merge-join engine's constants."""
    n = lane_lo.numel()
    for t, dt in ((lane_lo, torch.int32), (lane_hi, torch.int32),
                  (lane_mask, torch.bool), (sa, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("scan_core: bad dtype or layout")
    if lane_hi.numel() != n or lane_mask.numel() != n:
        raise ValueError("scan_core: lane arrays differ in length")
    args = (self_base, dir_base, rev_t0, max_cardinality, j0, k,
            int(reverse))
    if not _build.on_cuda(lane_lo, lane_hi, lane_mask, sa):
        return scan_core_plain(lane_lo, lane_hi, lane_mask, sa, *args)
    args += (MAX_MATCH_POS,)
    dev = sa.device
    if n == 0:
        return ScanResult(torch.zeros(1, dtype=torch.int32, device=dev),
                          0, 0)
    lib = _build.lib()
    stream = _build.stream_of(sa)
    ptrs = (lane_lo.data_ptr(), lane_hi.data_ptr(), lane_mask.data_ptr(),
            sa.data_ptr(), n)
    plan = kd_plan(n)
    work = torch.empty(plan.words, dtype=torch.int64, device=dev)
    wp = work.data_ptr()
    bufs = (plan.blocks, wp + 8 * plan.code_at, wp, wp + 8 * plan.tot_at)
    scan_core.launches += 1
    _build.check(lib.asgart_scan_count(*ptrs, *args, *bufs, stream),
                 "scan_core(count)")
    # the one read that sizing needs: n_events and total_kept
    n_events, _, total_kept = work[plan.tot_at: plan.tot_at + 3].tolist()
    flat = torch.empty(3 * n_events + total_kept + 1, dtype=torch.int32,
                       device=dev)
    a_evt = torch.empty(max(n_events, 1), dtype=torch.int32, device=dev)
    fp = flat.data_ptr()
    _build.check(lib.asgart_scan_emit(
        *ptrs, *args, *bufs, n_events, fp,
        fp + 4 * 3 * n_events, fp + 4 * (3 * n_events + total_kept),
        a_evt.data_ptr(), stream), "scan_core(emit)")
    return ScanResult(flat, n_events, total_kept)


scan_core.launches = 0


def scan_core_plain(lane_lo, lane_hi, lane_mask, sa, self_base, dir_base,
                    rev_t0, max_cardinality, j0, k, reverse) -> ScanResult:
    """Plain PyTorch version of the KD kernel: a flat CSR expansion of
    every masked window, then the same filters and compaction."""
    dev = sa.device
    n = lane_lo.numel()
    step = k // 2
    i64 = torch.int64
    cnt = torch.where(lane_mask, lane_hi - lane_lo, 0).to(i64)
    lane = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    starts = torch.cumsum(cnt, 0) - cnt
    x = lane_lo.to(i64)[lane] + (torch.arange(lane.numel(), device=dev)
                                 - starts[lane])
    m = sa[x].to(i64)
    i = (j0 + lane + 1) * step
    if reverse:
        dir_ok = m >= rev_t0 - i
    else:
        dir_ok = m > i + dir_base
    keep = (m != i + self_base) & (m < MAX_MATCH_POS) & dir_ok
    kept = torch.zeros(n, dtype=i64, device=dev).index_add_(
        0, lane, keep.to(i64))
    valid = lane_mask & (kept <= max_cardinality)
    event = valid & (kept > 0)
    quiet = torch.cumsum((valid & (kept == 0)).to(i64), 0)
    ev_lanes = torch.nonzero(event).flatten()
    a_evt = quiet[ev_lanes]
    z_before = a_evt - torch.cat([torch.zeros(1, dtype=i64, device=dev),
                                  a_evt[:-1]])
    last_quiet = quiet[-1] if n else torch.zeros((), dtype=i64, device=dev)
    z_trail = last_quiet - (a_evt[-1] if ev_lanes.numel() else 0)
    ev_pack = torch.stack([(j0 + ev_lanes + 1) * step, z_before,
                           kept[ev_lanes]])
    m_flat = m[keep & event[lane]]
    flat = torch.cat([ev_pack.flatten(), m_flat,
                      z_trail.reshape(1)]).to(torch.int32)
    return ScanResult(flat, int(ev_lanes.numel()), int(m_flat.numel()))
