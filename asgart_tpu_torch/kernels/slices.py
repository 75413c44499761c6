"""KO ``granule_totals`` and KP ``gather_flat``: the sliced dispatch of a
repeat-heavy chunk.

Kernels: ``csrc/slices.cu`` (see its header for what each replaces in the
JAX package and how it is bounded). ``granule_totals_plain`` and
``gather_flat_plain`` are the same functions in plain PyTorch.
"""

from __future__ import annotations

import array

import torch

from . import _build
from ..host_helpers import SLICE_GRAN


def granule_totals(lane_lo: torch.Tensor, lane_hi: torch.Tensor,
                   lane_mask: torch.Tensor, gran: int = SLICE_GRAN
                   ) -> torch.Tensor:
    """int64 [ceil(n / gran)]: the sum of ``lane_hi - lane_lo`` over the
    masked lanes of each granule of ``gran`` consecutive lanes, the last
    granule partial (the exact counterpart of the JAX float32
    ``_range_granule_totals`` and ``_raw_total_granules``)."""
    n = lane_lo.numel()
    for t, dt in ((lane_lo, torch.int32), (lane_hi, torch.int32),
                  (lane_mask, torch.bool)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("granule_totals: bad dtype or layout")
    if lane_hi.numel() != n or lane_mask.numel() != n:
        raise ValueError("granule_totals: lane arrays differ in length")
    if gran < 1:
        raise ValueError(f"granule_totals: bad granule {gran}")
    if not _build.on_cuda(lane_lo, lane_hi, lane_mask):
        return granule_totals_plain(lane_lo, lane_hi, lane_mask, gran)
    totals = torch.empty(-(-n // gran), dtype=torch.int64,
                         device=lane_lo.device)
    if n == 0:
        return totals
    lib = _build.lib()
    granule_totals.launches += 1
    _build.check(lib.asgart_granule_totals(
        lane_lo.data_ptr(), lane_hi.data_ptr(), lane_mask.data_ptr(), n,
        gran, totals.data_ptr(), _build.stream_of(lane_lo)),
        "granule_totals")
    return totals


granule_totals.launches = 0


def granule_totals_plain(lane_lo, lane_hi, lane_mask,
                         gran: int = SLICE_GRAN) -> torch.Tensor:
    """Plain PyTorch version of the KO kernel."""
    n = lane_lo.numel()
    counts = torch.where(lane_mask, lane_hi.long() - lane_lo.long(), 0)
    pad = -n % gran
    if pad:
        counts = torch.cat([counts, counts.new_zeros(pad)])
    return counts.reshape(-1, gran).sum(1)


# KP's by-value source tables (csrc/slices.cu SrcTable): a launch takes the
# smallest that holds its sources
KP_CAPACITIES = (8, 64, 1024)


def kp_capacity(n_src: int) -> int:
    """The capacity of the source table KP passes by value for ``n_src``
    sources, or 0 past the largest: then the table goes to the card."""
    for cap in KP_CAPACITIES:
        if n_src <= cap:
            return cap
    return 0


def gather_flat(srcs, idx: torch.Tensor) -> torch.Tensor:
    """int32 [n]: ``src.reshape(-1)[idx]``, where ``src`` is the flat
    concatenation of the int32 tensors ``srcs`` (not made: the kernel reads
    each in place) and ``idx`` int64 [n] holds indices into it, each in
    [0, its length)."""
    srcs = list(srcs)
    for t in srcs:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("gather_flat: sources must be contiguous int32")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise ValueError("gather_flat: idx must be contiguous int64")
    if not srcs:
        raise ValueError("gather_flat: no source")
    if not _build.on_cuda(idx, *srcs):
        return gather_flat_plain(srcs, idx)
    n, S = idx.numel(), len(srcs)
    out = torch.empty(n, dtype=torch.int32, device=idx.device)
    if n == 0:
        return out
    lib = _build.lib()
    table = array.array("q", [t.data_ptr() for t in srcs])  # then offsets
    o = 0
    for t in srcs:
        table.append(o)
        o += t.numel()
    table.append(o)
    cap = kp_capacity(S)
    if cap:
        table_ptr = table.buffer_info()[0]
    else:  # the table form: the table on the card
        table = torch.frombuffer(table, dtype=torch.int64).to(idx.device)
        table_ptr = table.data_ptr()
    gather_flat.launches += 1
    _build.check(lib.asgart_gather_flat(
        table_ptr, S, cap, idx.data_ptr(), n, out.data_ptr(),
        _build.stream_of(idx)), "gather_flat")
    return out


gather_flat.launches = 0


def gather_flat_plain(srcs, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the KP kernel."""
    return torch.cat([t.reshape(-1) for t in srcs])[idx]
