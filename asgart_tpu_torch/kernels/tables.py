"""KJ ``invert_tables`` and KM ``table_ranges``: the table engine's
position tables, and each probe lane's read of them.

Kernels: KJ is the table form of KC's partitioned scatter
(``csrc/invert.cu``, its scratch laid out by
:func:`~asgart_tpu_torch.kernels.invert.kc_plan` with no direct row), KM
``csrc/tables.cu`` (see their headers for what they replace in the JAX
package and how they are bounded). ``invert_tables_plain`` and
``table_ranges_plain`` are the same functions in plain PyTorch.
"""

from __future__ import annotations

import array

import torch

from ..host_helpers import _probe_x0
from . import _build
from .invert import kc_plan


def decimated_size(n: int, step: int) -> tuple[int, int]:
    """(C, step * C): the columns of the decimated layout of n positions
    (position x at (x % step) * C + x // step) and its entries."""
    C = -(-n // step)
    return C, step * C


def decimated_index(x, step: int, C: int):
    """The decimated index of position(s) ``x`` (an int, a numpy array or
    a tensor): (x % step) * C + x // step (:func:`decimated_size`)."""
    return (x % step) * C + x // step


def invert_tables(sa: torch.Tensor, run_lo: torch.Tensor,
                  run_hi: torch.Tensor, step: int):
    """Scatter the slot-indexed run bounds of the sorted text to its
    positions: ``pos_lo[sa] = run_lo`` (the N-probe flag in the sign bit,
    as KB sets it), ``pos_hi[sa] = run_hi`` and ``rank[sa] = run_lo &
    0x7FFFFFFF``; ``sa`` (int32 [n]) must be a permutation of [0, n).
    pos_lo and pos_hi are decimated by ``step`` (:func:`decimated_size`;
    their entries past the n positions are 0; step 1 is position order),
    rank is in position order (the table index's step is k // 2).

    Returns (pos_lo, pos_hi [step * C], rank [n]), int32 each."""
    n = sa.numel()
    for t in (sa, run_lo, run_hi):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.numel() != n:
            raise ValueError("invert_tables: sa, run_lo and run_hi must be "
                             "contiguous int32 of one length")
    if step < 1:
        raise ValueError(f"invert_tables: bad step {step}")
    if not _build.on_cuda(sa, run_lo, run_hi):
        return invert_tables_plain(sa, run_lo, run_hi, step)
    dev = sa.device
    _, size = decimated_size(n, step)
    pos_lo, pos_hi = (torch.empty(size, dtype=torch.int32, device=dev)
                      for _ in range(2))
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return pos_lo, pos_hi, rank
    plan = kc_plan(n, 0)
    scratch = torch.empty(plan.words, dtype=torch.int32, device=dev)
    sp = scratch.data_ptr()
    lib = _build.lib()
    invert_tables.launches += 1
    _build.check(lib.asgart_invert_tables(
        sa.data_ptr(), run_lo.data_ptr(), run_hi.data_ptr(), n, sp,
        plan.coarse, plan.tiles, *(sp + 4 * w for w in (
            plan.d1_at, plan.l1_at, plan.h1_at, plan.d2_at, plan.l2_at,
            plan.h2_at)), pos_lo.data_ptr(), pos_hi.data_ptr(),
        rank.data_ptr(), step, _build.stream_of(sa)), "invert_tables")
    return pos_lo, pos_hi, rank


invert_tables.launches = 0


def invert_tables_plain(sa, run_lo, run_hi, step):
    """Plain PyTorch version of the KJ kernel."""
    n = sa.numel()
    C, size = decimated_size(n, step)
    p = sa.long()
    pos_lo, pos_hi = (torch.zeros(size, dtype=torch.int32, device=sa.device)
                      for _ in range(2))
    rank = torch.empty(n, dtype=torch.int32, device=sa.device)
    dec = decimated_index(p, step, C)
    pos_lo[dec] = run_lo
    pos_hi[dec] = run_hi
    rank[p] = run_lo & 0x7FFFFFFF
    return pos_lo, pos_hi, rank


def table_x0s(specs, n1: int, k: int, reverse: bool, complement: bool):
    """(lane_off [n_chunks + 1], x0 [n_chunks], cl [n_chunks]) as Python
    ints: each chunk's first lane, and the table position of its probe
    j = 0 (``_probe_x0``: in the appended half for R/C runs)."""
    lane_off = [0]
    x0s, cls = [], []
    for (cs, cl, nc) in specs:
        lane_off.append(lane_off[-1] + nc)
        x0s.append(_probe_x0(cs, cl, n1, k, reverse, complement))
        cls.append(cl)
    return lane_off, x0s, cls


# csrc/tables.cu kOffCap: the chunks whose table goes in KM's launch; past
# it the table is copied from pinned memory, which took 0.0025-0.0036 ms
# more alone and 0.006-0.036 more a call with 1-2 chunks (NVIDIA H100 80GB
# HBM3, 700 W; scripts/km_kf_probe.py)
KM_OFF_CAPACITY = 256


def km_table(lane_off, x0s, cls, k: int, n: int) -> list[int]:
    """KM's chunk table (csrc/tables.cu), 3 n_chunks + 1 ints: each chunk's
    first lane and the total; the decimated index (C = ceil(n / step)) of
    each chunk's probe j = 0; each chunk's live lanes, the j with j * step
    < len - k - step and x0 + j * step < n (at most its lanes)."""
    step = k // 2
    C, _ = decimated_size(n, step)
    base, live = [], []
    for c, (x0, cl) in enumerate(zip(x0s, cls)):
        nc = lane_off[c + 1] - lane_off[c]
        b = cl - k - step
        m = min(nc, -(-b // step) if b > 0 else 0,
                -(-(n - x0) // step) if n > x0 else 0)
        live.append(m)
        base.append(decimated_index(x0, step, C) if m else 0)
    return list(lane_off) + base + live


def table_ranges(pos_lo: torch.Tensor, pos_hi: torch.Tensor, specs,
                 first_len: int, k: int, reverse: bool, complement: bool):
    """Every chunk's probe lanes read from the position tables: ``specs``
    = ((chunk_start, chunk_len, n_lanes), ...), lanes back-to-back; lane j
    of a chunk reads position ``_probe_x0 + j * (k // 2)`` of the tables of
    a strand of ``first_len`` bytes (n text positions: 2 first_len - 1 for
    R/C runs), decimated by step = k // 2 (:func:`invert_tables`).

    Returns (lane_lo int32 [total], lane_hi int32 [total], lane_mask bool
    [total], totals int64 [n_chunks], lane_off): lanes whose probe starts
    with N (pos_lo's sign bit) or lies past the chunk's bound are masked
    out with (0, 0); totals are the exact sums of (lane_hi - lane_lo) over
    each chunk's live lanes. On the card the call does not wait for it."""
    if not 2 <= k:
        raise ValueError(f"table_ranges: bad k={k}")
    n = 2 * first_len - 1 if reverse or complement else first_len
    _, size = decimated_size(n, k // 2)
    for t in (pos_lo, pos_hi):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.numel() != size:
            raise ValueError("table_ranges: pos_lo and pos_hi must be "
                             "contiguous int32 of the decimated layout")
    lane_off, x0s, cls = table_x0s(specs, first_len, k, reverse, complement)
    if not _build.on_cuda(pos_lo, pos_hi):
        return (*table_ranges_plain(pos_lo, pos_hi, lane_off, x0s, cls, k,
                                    n), lane_off)
    dev = pos_lo.device
    total = lane_off[-1]
    n_chunks = len(specs)
    if total >= 1 << 31:
        raise ValueError("table_ranges: lanes past int32 offsets")
    lane_lo = torch.empty(total, dtype=torch.int32, device=dev)
    lane_hi = torch.empty(total, dtype=torch.int32, device=dev)
    lane_mask = torch.empty(total, dtype=torch.bool, device=dev)
    if total == 0:
        return (lane_lo, lane_hi, lane_mask,
                torch.zeros(n_chunks, dtype=torch.int64, device=dev),
                lane_off)
    totals = torch.empty(n_chunks, dtype=torch.int64, device=dev)
    table = array.array("i", [v - (1 << 32) if v >= 1 << 31 else v
                              for v in km_table(lane_off, x0s, cls, k, n)])
    cap = KM_OFF_CAPACITY if n_chunks <= KM_OFF_CAPACITY else 0
    if cap:
        ptr = table.buffer_info()[0]
    else:  # the table on the card, copied from pinned memory
        table = torch.frombuffer(table, dtype=torch.int32).pin_memory() \
            .to(dev, non_blocking=True)
        ptr = table.data_ptr()
    lib = _build.lib()
    table_ranges.launches += 1
    _build.check(lib.asgart_table_ranges(
        pos_lo.data_ptr(), pos_hi.data_ptr(), ptr, n_chunks, cap, total,
        lane_lo.data_ptr(), lane_hi.data_ptr(), lane_mask.data_ptr(),
        totals.data_ptr(), _build.stream_of(pos_lo)), "table_ranges")
    return lane_lo, lane_hi, lane_mask, totals, lane_off


table_ranges.launches = 0


def table_ranges_plain(pos_lo, pos_hi, lane_off, x0s, cls, k, n):
    """Plain PyTorch version of the KM kernel (the arguments after
    :func:`table_x0s`, and the text's n positions): gathers at the probe
    positions' decimated indexes, then the masks and the per-chunk
    sums."""
    dev = pos_lo.device
    step = k // 2
    C, _ = decimated_size(n, step)
    i64 = torch.int64
    counts = torch.tensor([lane_off[i + 1] - lane_off[i]
                           for i in range(len(x0s))], dtype=i64, device=dev)
    chunk = torch.repeat_interleave(torch.arange(len(x0s), device=dev),
                                    counts)
    j = torch.arange(lane_off[-1], dtype=i64, device=dev) - \
        torch.tensor(lane_off[:-1] or [0], dtype=i64, device=dev)[chunk]
    x = torch.tensor(x0s or [0], dtype=i64, device=dev)[chunk] + j * step
    cl = torch.tensor(cls or [0], dtype=i64, device=dev)[chunk]
    inside = (j * step < cl - k - step) & (x < n)
    xc = torch.where(inside, decimated_index(x, step, C), 0)
    raw = pos_lo[xc]
    mask = inside & (raw >= 0)
    lane_lo = torch.where(mask, raw & 0x7FFFFFFF, 0)
    lane_hi = torch.where(mask, pos_hi[xc], 0)
    csum = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                      torch.cumsum((lane_hi - lane_lo).to(i64), 0)])
    off = torch.tensor(lane_off, dtype=i64, device=dev)
    return lane_lo, lane_hi, mask, csum[off[1:]] - csum[off[:-1]]
