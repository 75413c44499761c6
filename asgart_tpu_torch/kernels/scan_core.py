"""KD ``scan_core``: match filters and event compaction for one chunk.

Kernel: ``csrc/scan_core.cu`` (three launches around one ``torch.cumsum``).
``scan_core_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build

# the fused engine's match-position cutoff (device_engine.py:1846): neutral
MAX_MATCH_POS = 2**31 - 1


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


def scan_core(lane_lo: torch.Tensor, lane_hi: torch.Tensor,
              lane_mask: torch.Tensor, sa: torch.Tensor, chunk_start: int,
              chunk_len: int, max_cardinality: int, j0: int, k: int,
              reverse: bool) -> ScanResult:
    """Events and kept matches of the lanes ``lane_lo/hi/mask`` (one
    chunk's lane slice; lane l probes i = (j0 + l + 1) * (k // 2)) over
    the suffix order ``sa`` — the live prefixes of the JAX
    ``_scan_core`` outputs (asgart_tpu/device_engine.py:352)."""
    n = lane_lo.numel()
    for t, dt in ((lane_lo, torch.int32), (lane_hi, torch.int32),
                  (lane_mask, torch.bool), (sa, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("scan_core: bad dtype or layout")
    if lane_hi.numel() != n or lane_mask.numel() != n:
        raise ValueError("scan_core: lane arrays differ in length")
    args = (chunk_start, chunk_len, max_cardinality, j0, k, int(reverse))
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
    flags = torch.empty((3, n), dtype=torch.int32, device=dev)
    scan_core.launches += 1
    _build.check(lib.asgart_scan_count(*ptrs, *args, flags.data_ptr(),
                                       stream), "scan_core(count)")
    cums = torch.cumsum(flags, dim=1, dtype=torch.int64)
    n_events, _, total_kept = cums[:, -1].tolist()
    flat = torch.empty(3 * n_events + total_kept + 1, dtype=torch.int32,
                       device=dev)
    a_evt = torch.empty(max(n_events, 1), dtype=torch.int32, device=dev)
    fp = flat.data_ptr()
    _build.check(lib.asgart_scan_emit(
        *ptrs, *args, flags.data_ptr(), cums.data_ptr(), n_events, fp,
        fp + 4 * 3 * n_events, fp + 4 * (3 * n_events + total_kept),
        a_evt.data_ptr(), stream), "scan_core(emit)")
    return ScanResult(flat, n_events, total_kept)


scan_core.launches = 0


def scan_core_plain(lane_lo, lane_hi, lane_mask, sa, chunk_start,
                    chunk_len, max_cardinality, j0, k, reverse
                    ) -> ScanResult:
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
        dir_ok = m >= chunk_start + chunk_len - i
    else:
        dir_ok = m > i + chunk_start
    keep = (m != i) & (m < MAX_MATCH_POS) & dir_ok
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
