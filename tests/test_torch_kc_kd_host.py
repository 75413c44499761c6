"""The host side of KC ``invert_fused`` and KD ``scan_core``, on the CPU
with the kernel library faked (the inputs reported as GPU tensors, each
entry point a Python function that records its arguments):

- KC's plan (:func:`kc_plan`: buckets of 2^21 destinations and tiles of
  2^13, the scratch's planes and their offsets) and KD's (:func:`kd_plan`:
  block sums, totals and codes in one int64 buffer), each pinned at its
  edges;
- KC's chunk offsets: passed by value (the host array's words, read
  through the pointer the wrapper hands over) up to ``KC_OFF_CAPACITY``
  chunks, with no tensor made, and past it as a tensor (the table form);
  no launch and zero totals when there is no row;
- KD's buffers: the count launch gets the plan's code, block-sum and total
  pointers, the wrapper sizes ``flat`` from the two totals it reads there,
  and the emit launch gets ev_pack, m_flat and z_trail at their offsets in
  ``flat``.

The kernels themselves are held to their plain versions on the GPU
(tests/test_torch_cuda.py) and, through the plain versions, to the JAX
package (tests/test_torch_index.py, tests/test_torch_scan_core.py).
Exact (integers)."""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from asgart_tpu_torch.kernels import _build

from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

invert = importlib.import_module("asgart_tpu_torch.kernels.invert")
scan = importlib.import_module("asgart_tpu_torch.kernels.scan_core")


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


@pytest.mark.parametrize("M,W,coarse,tiles", [
    (1, 1, 1, 1), (1, 0, 1, 1), (2, 1, 1, 1), (8192, 8192, 1, 1),
    (8193, 8192, 1, 2), (1 << 21, 1 << 21, 1, 256),
    ((1 << 21) + 1, 1 << 21, 2, 257), ((1 << 21) + 3, 5, 2, 257),
    (3 << 21, (1 << 21) + 7, 3, 768),
    ((1 << 31) - 1, (1 << 31) - 1, 1024, 1 << 18),
    ((1 << 31) - 1, (1 << 30) + 9, 1024, 1 << 18)])
def test_kc_plan_edges(M, W, coarse, tiles):
    """Buckets of 2^21 destinations (at most 1024 below 2^31 rows) and
    tiles of 2^13; the cursors of both first, then each partition pass's
    dest and run_lo planes of M slots and, with probe rows, its run_hi
    plane from the first slot of the bucket (tile) that holds W; every
    plane 16-byte aligned, in order and apart."""
    p = invert.kc_plan(M, W)
    assert (invert.KC_COARSE, invert.KC_TILE) == (21, 13)
    assert (p.coarse, p.tiles) == (coarse, tiles)
    assert p.d1_at >= coarse + tiles
    lanes = M > W
    at = p.d1_at
    for d, lo, hi, first, shift in ((p.d1_at, p.l1_at, p.h1_at, p.h1_first,
                                     21),
                                    (p.d2_at, p.l2_at, p.h2_at, p.h2_first,
                                     13)):
        assert d >= at and lo >= d + M
        at = lo + M
        if lanes:
            assert first == W >> shift << shift and hi >= at
            at = hi + M - first
        else:
            assert hi == first == 0
        assert all(x % 4 == 0 for x in (d, lo, hi))
    assert at <= p.words < at + 4


def test_kc_plan_past_int32_raises():
    with pytest.raises(ValueError, match="int32"):
        invert.kc_plan(1 << 31, 1 << 31)


@pytest.mark.parametrize("n,blocks", [(1, 1), (1023, 1), (1024, 1),
                                      (1025, 2), (1 << 20, 1024),
                                      ((1 << 31) - 1, 1 << 21)])
def test_kd_plan_edges(n, blocks):
    """One block sum per 1024 lanes in each of three rows, the three
    totals after them, then the int32 codes from an int64 word: one per
    lane."""
    p = scan.kd_plan(n)
    assert scan.KD_BLOCK_LANES == 1024
    assert p.blocks == blocks == -(-n // 1024)
    assert (p.tot_at, p.code_at) == (3 * blocks, 3 * blocks + 3)
    assert p.words == p.code_at + -(-n // 2)
    assert 8 * (p.words - p.code_at) >= 4 * n


class _KcLib:
    def __init__(self):
        self.calls = []

    def asgart_invert_fused(self, *a):
        (sa, lo, hi, mask, M, W, off, n_chunks, cap, cursor, coarse, tiles,
         d1, l1, h1, h1_first, d2, l2, h2, h2_first, rank, lane_lo, lane_hi,
         totals, stream) = a
        words = list((ctypes.c_int64 * (n_chunks + 1)).from_address(off))
        self.calls.append(dict(M=M, W=W, words=words, n_chunks=n_chunks,
                               cap=cap, counts=(coarse, tiles),
                               planes=(cursor, d1, l1, h1, d2, l2, h2),
                               firsts=(h1_first, h2_first),
                               outs=(rank, lane_lo, lane_hi, totals)))
        return 0


def _kc_inputs(M, W, n_chunks):
    sa = torch.arange(M, dtype=torch.int32)
    total = M - W  # 3 lanes a chunk
    return (sa, sa.clone(), sa.clone(), torch.ones(total, dtype=torch.bool),
            W, [min(3 * c, total) for c in range(n_chunks + 1)])


@pytest.mark.parametrize("n_chunks,cap", [(0, 256), (1, 256), (256, 256),
                                          (257, 0)])
def test_invert_fused_offset_table_form(monkeypatch, n_chunks, cap):
    """KC's chunk offsets go in the launch by value (the host words behind
    the pointer the wrapper passes, no tensor made) up to 256 chunks, and
    to the card past them (cap 0); the scratch's planes at the plan's
    offsets; one launch counted."""
    lib = _KcLib()
    _fake(monkeypatch, lib)
    made = []
    real = torch.frombuffer
    monkeypatch.setattr(torch, "frombuffer",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    M = 1000 + 3 * n_chunks
    W = 1000
    sa, lo, hi, mask, W, lane_off = _kc_inputs(M, W, n_chunks)
    before = invert.invert_fused.launches
    rank, lane_lo, lane_hi, totals = invert.invert_fused(sa, lo, hi, mask, W,
                                                         lane_off)
    assert invert.invert_fused.launches == before + 1
    (c,) = lib.calls
    assert (c["M"], c["W"], c["n_chunks"], c["cap"]) == (M, W, n_chunks, cap)
    assert c["words"] == lane_off
    assert len(made) == (cap == 0)
    p = invert.kc_plan(M, W)
    assert c["counts"] == (p.coarse, p.tiles)
    assert c["firsts"] == (p.h1_first, p.h2_first)
    cursor = c["planes"][0]
    assert [x - cursor if x else None for x in c["planes"][1:]] == [
        4 * w if w else None for w in (p.d1_at, p.l1_at, p.h1_at, p.d2_at,
                                       p.l2_at, p.h2_at)]
    assert c["outs"][:3] == (rank.data_ptr(), lane_lo.data_ptr(),
                             lane_hi.data_ptr())
    if n_chunks:  # (an empty view's data_ptr is 0)
        assert c["outs"][3] == totals.data_ptr()
    assert rank.shape == (W,) and lane_lo.shape == lane_hi.shape == (M - W,)
    assert totals.shape == (n_chunks,) and totals.dtype == torch.int64


def test_invert_fused_no_rows(monkeypatch):
    """No row: no launch, and every chunk's total 0."""
    lib = _KcLib()
    _fake(monkeypatch, lib)
    e32 = torch.zeros(0, dtype=torch.int32)
    before = invert.invert_fused.launches
    rank, lane_lo, lane_hi, totals = invert.invert_fused(
        e32, e32, e32, torch.zeros(0, dtype=torch.bool), 0, [0, 0, 0])
    assert invert.invert_fused.launches == before and not lib.calls
    assert rank.numel() == lane_lo.numel() == lane_hi.numel() == 0
    assert totals.tolist() == [0, 0]


class _KdLib:
    """count writes the totals (n_events, quiet, total_kept) where the
    wrapper will read them; emit records its pointers."""

    def __init__(self, n_events, quiet, kept):
        self.tot = (n_events, quiet, kept)
        self.calls = []

    def asgart_scan_count(self, *a):
        blocks, code, sums, tot, stream = a[-5:]
        (ctypes.c_int64 * 3).from_address(tot)[:] = self.tot
        self.calls.append(("count", a[4], blocks, code, sums, tot))
        return 0

    def asgart_scan_emit(self, *a):
        self.calls.append(("emit", *a[-10:-1]))
        return 0


@pytest.mark.parametrize("n,n_events,kept", [(1, 0, 0), (1, 1, 3),
                                             (1024, 7, 0), (1025, 31, 900),
                                             (100_000, 4_000, 12_345)])
def test_scan_core_buffers(monkeypatch, n, n_events, kept):
    """KD's count launch gets the plan's code, block-sum and total
    pointers; the wrapper sizes flat = [ev_pack 3 x n_events | m_flat
    total_kept | z_trail] from the totals it reads back, and the emit
    launch writes each part at its offset."""
    lib = _KdLib(n_events, 5, kept)
    _fake(monkeypatch, lib)
    rng = np.random.default_rng(n)
    lo = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    mask = torch.ones(n, dtype=torch.bool)
    sa = torch.zeros(100, dtype=torch.int32)
    before = scan.scan_core.launches
    res = scan.scan_core(lo, lo + 1, mask, sa, 0, 0, 0, 8, 0, 20, False)
    assert scan.scan_core.launches == before + 1
    count, emit = lib.calls
    p = scan.kd_plan(n)
    _, n_lanes, blocks, code, sums, tot = count
    assert (n_lanes, blocks) == (n, p.blocks)
    assert (code - sums, tot - sums) == (8 * p.code_at, 8 * p.tot_at)
    assert (res.n_events, res.total_kept) == (n_events, kept)
    assert res.flat.numel() == 3 * n_events + kept + 1
    e_blocks, e_code, e_sums, e_tot, e_n, ev, m, z, a_evt = emit[1:]
    assert (e_blocks, e_code, e_sums, e_tot, e_n) == (blocks, code, sums,
                                                      tot, n_events)
    fp = res.flat.data_ptr()
    assert (ev, m, z) == (fp, fp + 12 * n_events,
                          fp + 4 * (3 * n_events + kept))


def test_scan_core_no_lanes(monkeypatch):
    """No lane: no launch, and a result of one z_trail of 0."""
    lib = _KdLib(0, 0, 0)
    _fake(monkeypatch, lib)
    e = torch.zeros(0, dtype=torch.int32)
    before = scan.scan_core.launches
    res = scan.scan_core(e, e, torch.zeros(0, dtype=torch.bool),
                         torch.zeros(4, dtype=torch.int32), 0, 0, 0, 8, 0,
                         20, False)
    assert scan.scan_core.launches == before and not lib.calls
    assert (res.n_events, res.total_kept, res.flat.tolist()) == (0, 0, [0])
