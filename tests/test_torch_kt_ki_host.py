"""The designs of KT ``gather_owned`` and KI ``unpack_codes`` on the CPU:

- a numpy model of KT's kernel (csrc/sharded.cu) warp by warp: the lane
  stream one thread a lane over a grid-stride loop whose bound is the
  same for a warp's 32 threads, the ballot of the lanes with entries, the
  warp serving them in ballot order with every entry's row clipped to the
  rank's rows and 0 elsewhere, held exactly to ``gather_owned_plain`` on
  lanes at warp and block edges, warps with no live lane, lanes of more
  than 32 and more than 1024 entries, lanes spanning three shards, a rank
  that owns no row, masked lanes with hi > lo, n = 1 and total = 0; each
  lane's bounds read once, its offset only where it has entries, every
  entry written once;
- a numpy model of KI's kernel (csrc/codes.cu) tile by tile: tiles of
  packed bytes aligned in the address space, one 16-byte load a thread,
  each quarter's words at their own shift, the SWAR ranks, 16-byte stores
  aligned in the codes' address space and byte stores only within 16 bytes
  of a span's two edges, held exactly to ``unpack_codes_plain`` at every
  n1 mod 64 around a tile's edge, with ``packed`` and ``codes`` at byte
  offsets 0-15, exceptions at the quarters' edges and at n1 - 1, and n1 <
  16;
- both launches with the library faked (one launch counted a call,
  nothing launched for total = 0 or n1 = 0), and the rank-sharded
  engine's gather handed each whole chunk's exact total (no host read of
  the buffer's length).

The kernels themselves are held to their plain versions on the GPU
(tests/test_torch_cuda.py). Exact (integers)."""

import importlib

import numpy as np
import pytest
import torch

from asgart_tpu_torch.kernels import _build

from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

sharded = importlib.import_module("asgart_tpu_torch.kernels.sharded")
codes_mod = importlib.import_module("asgart_tpu_torch.kernels.codes")
device_engine = importlib.import_module("asgart_tpu_torch.device_engine")

THREADS = 256       # asgart::kThreads
GRID_CAP = 132 * 32  # asgart::grid_for's cap
KI_TILE = 16 * THREADS  # csrc/codes.cu kTile


def grid_for(n, cap=GRID_CAP):
    return max(1, min(-(-n // THREADS), cap))


# --- a numpy model of csrc/sharded.cu -------------------------------------

def model_gather_owned(lo, hi, mask, off, total, sa_local, row0,
                       cap=GRID_CAP):
    """flat int64 [total] as KT's kernel writes it, with its reads and
    writes counted; ``cap`` is the grid's cap (the kernel's grid_for)."""
    n = len(lo)
    flat = np.zeros(total, np.int64)
    writes = np.zeros(total, np.int64)
    lane_reads = np.zeros(n, np.int64)
    off_reads = np.zeros(n, np.int64)
    if n == 0:
        return flat, writes, lane_reads, off_reads
    blocks = grid_for(n, cap)
    stride = blocks * THREADS
    n_local = len(sa_local)
    for base0 in range(0, stride, 32):  # each warp's first lane
        for base in range(base0, n, stride):  # bound uniform over the warp
            lanes = base + np.arange(32)
            ok = lanes < n
            lo_w = np.zeros(32, np.int64)
            cnt = np.zeros(32, np.int64)
            idx = lanes[ok]
            lane_reads[idx] += 1
            m = mask[idx]
            lo_w[:len(idx)] = np.where(m, lo[idx], 0)
            cnt[:len(idx)] = np.where(m, hi[idx] - lo[idx], 0)
            live = cnt > 0  # the ballot
            o = np.zeros(32, np.int64)
            o[live] = off[lanes[live]]
            off_reads[lanes[live]] += 1
            for src in np.flatnonzero(live):  # __ffs order
                for t0 in range(32):  # thread t0 writes t0, t0 + 32, ...
                    t = np.arange(t0, cnt[src], 32)
                    row = lo_w[src] + t - row0
                    own = (row >= 0) & (row < n_local)
                    flat[o[src] + t] = np.where(
                        own, sa_local[np.clip(row, 0, max(n_local - 1, 0))]
                        if n_local else 0, 0)
                    writes[o[src] + t] += 1
    return flat, writes, lane_reads, off_reads


def _lanes(rng, n, W, span, live_share=1.0, mask_share=0.9):
    lo = rng.integers(0, W, n)
    hi = np.minimum(W, lo + rng.integers(0, span + 1, n))
    hi = np.where(rng.random(n) < live_share, hi, lo)
    mask = rng.random(n) < mask_share
    return lo, hi, mask


def _hold_kt(lo, hi, mask, W, n_ranks, cap=GRID_CAP, empty_rank=False):
    """Every rank's shard through the model against gather_owned_plain;
    the ranks' sum against the windows of the whole order."""
    lo_t, hi_t = (torch.from_numpy(np.asarray(a, np.int32)) for a in (lo, hi))
    m_t = torch.from_numpy(np.asarray(mask, bool))
    off, total = sharded.csr_offsets(lo_t, hi_t, m_t)
    sa = np.random.default_rng(W).permutation(W).astype(np.int32)
    Wl = -(-W // n_ranks)
    summed = np.zeros(total, np.int64)
    for r in range(n_ranks + empty_rank):
        a, b = min(W, r * Wl), min(W, (r + 1) * Wl)
        shard = torch.from_numpy(sa[a:b].copy())
        want = sharded.gather_owned_plain(lo_t, hi_t, m_t, off, total, shard,
                                          a)
        got, writes, lane_reads, off_reads = model_gather_owned(
            np.asarray(lo, np.int64), np.asarray(hi, np.int64),
            np.asarray(mask, bool), off.numpy(), total, sa[a:b], a, cap)
        assert np.array_equal(got, want.numpy())
        assert (writes == 1).all()  # every entry once
        assert (lane_reads == 1).all()  # the lane stream read once
        live = np.asarray(mask, bool) & (np.asarray(hi) > np.asarray(lo))
        assert np.array_equal(off_reads, live.astype(np.int64))
        summed += got
    want = [sa[x:y] for x, y, m in zip(lo, hi, mask) if m]
    assert np.array_equal(
        summed, np.concatenate(want) if want else np.zeros(0, np.int64))
    return total


@pytest.mark.parametrize("n_ranks", [1, 3, 4])
def test_kt_model_random_lanes(n_ranks):
    """Random windows of a 5,000-row order (most lanes without entries,
    some masked with hi > lo), each shard and their sum; a grid capped at
    2 blocks, so warps walk the grid-stride loop several times."""
    rng = np.random.default_rng(7 + n_ranks)
    lo, hi, mask = _lanes(rng, 3001, 5000, 40, live_share=0.05)
    assert (~mask & (hi > lo)).any()  # masked lanes with entries
    for cap in (GRID_CAP, 2):
        _hold_kt(lo, hi, mask, 5000, n_ranks, cap)


def test_kt_model_warp_and_block_edges():
    """Live lanes at the first and last thread of warps and blocks, and
    around the grid's stride; whole warps with no live lane between."""
    n = 2 * 2 * THREADS + 33
    lo = np.zeros(n, np.int64)
    hi = np.zeros(n, np.int64)
    for l in (0, 31, 32, 63, THREADS - 1, THREADS, 2 * THREADS - 1,
              2 * THREADS, 4 * THREADS - 1, 4 * THREADS, n - 1):
        lo[l], hi[l] = l % 97, l % 97 + 1 + l % 5
    mask = np.ones(n, bool)
    assert _hold_kt(lo, hi, mask, 200, 2, cap=2) > 0


def test_kt_model_long_lanes():
    """A lane of 33 entries, one of 1,025 and one of 5,000 spanning three
    shards of four, among short ones; a rank past the last row owns
    none."""
    W = 8000
    lo = np.array([0, 100, 1500, 7990, 3, 2000], np.int64)
    hi = np.array([1, 133, 2525, 8000, 3, 7000], np.int64)
    mask = np.array([True, True, True, True, True, True])
    assert _hold_kt(lo, hi, mask, W, 4, empty_rank=True) == \
        1 + 33 + 1025 + 10 + 5000


def test_kt_model_small_and_empty():
    """n = 1 (live, masked out, empty), total = 0 and no lane."""
    for lo, hi, mask in (([5], [9], [True]), ([5], [9], [False]),
                         ([5], [5], [True]), ([], [], [])):
        _hold_kt(np.array(lo, np.int64), np.array(hi, np.int64),
                 np.array(mask, bool), 12, 3, empty_rank=True)


# --- a numpy model of csrc/codes.cu ---------------------------------------

def ranks4(w: np.ndarray, q: int) -> np.ndarray:
    """The kernel's SWAR ranks of the bit pairs q of uint32 words."""
    t = (w >> np.uint32(2 * q)) & np.uint32(0x03030303)
    return (t + np.uint32(0x01010101)
            + (t & (t >> np.uint32(1)) & np.uint32(0x01010101)))


def model_unpack(packed: np.ndarray, n1: int, pmis: int, cmis: int):
    """codes uint8 [n1] as KI's unpack writes them (before the exception
    scatter) with ``packed`` at address ≡ pmis and ``codes`` at address ≡
    cmis (mod 16); checks the alignment of every 16-byte load and store,
    that byte stores lie within 16 bytes of a span's edges and that every
    position is written once."""
    n4 = len(packed)
    out = np.zeros(n1, np.uint8)
    writes = np.zeros(n1, np.int64)
    n_tiles = -(-(n4 + pmis) // KI_TILE)
    tid = np.arange(THREADS)
    for tile in range(n_tiles):
        j0 = tile * KI_TILE - pmis
        # the tile's bytes, zeros where invalid, and 32 zero bytes past it
        # (the block's last thread's neighbour word)
        loc = np.zeros(KI_TILE + 32, np.uint8)
        j = j0 + np.arange(KI_TILE)
        ok = (j >= 0) & (j < n4)
        loc[:KI_TILE][ok] = packed[j[ok]]
        jw = j0 + 16 * tid
        vec = (jw >= 0) & (jw + 16 <= n4)
        assert ((pmis + jw[vec]) % 16 == 0).all()
        i_lo = max(0, -j0)
        i_hi = min(KI_TILE, n4 - j0)
        for q in range(4):
            base = q * n4 + j0
            i_end = min(n1 - base, i_hi)
            if i_end <= i_lo:
                continue
            sh = (pmis - cmis - q * n4) % 16
            s = 16 * tid + sh
            win = loc[s[:, None] + np.arange(16)]  # [THREADS, 16]
            word = ranks4(win.copy().view("<u4"), q).view(np.uint8)
            full = (s >= i_lo) & (s + 16 <= i_end)
            for t in np.flatnonzero(full):
                assert (cmis + base + s[t]) % 16 == 0
                out[base + s[t]: base + s[t] + 16] = word[t]
                writes[base + s[t]: base + s[t] + 16] += 1
            stores = []  # (local index, code) of byte stores
            for t in np.flatnonzero(~full & (s + 16 > i_lo) & (s < i_end)):
                stores += [(s[t] + m, word[t, m]) for m in range(16)
                           if i_lo <= s[t] + m < i_end]
            if sh > i_lo:  # thread 0's head
                head = ranks4(loc[:16].copy().view("<u4"), q).view(np.uint8)
                stores += [(m, head[m]) for m in range(i_lo, min(sh, i_end))]
            for i, c in stores:
                assert i < i_lo + 16 or i >= i_end - 16
                out[base + i] = c
                writes[base + i] += 1
    assert (writes == 1).all()
    return out


def _strand(rng, n1, exc_at=()):
    """(strand bytes, its pack): ACGT with N and '$' at ``exc_at`` and at
    n1 - 1."""
    from asgart_tpu_torch.codes import pack_codes

    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n1)].copy()
    for p in exc_at:
        if 0 <= p < n1:
            g[p] = ord("N")
    g[n1 - 1] = ord("$")
    return g, pack_codes(g)


def _view(a: np.ndarray, mis: int) -> torch.Tensor:
    """``a`` as a tensor view whose address is ≡ mis (mod 16)."""
    buf = torch.zeros(len(a) + 32, dtype=torch.uint8)
    o = (mis - buf.data_ptr()) % 16
    v = buf[o: o + len(a)]
    v.copy_(torch.from_numpy(a))
    assert v.data_ptr() % 16 == mis
    return v


def _hold_ki(n1, pmis, cmis, rng, exc_quarters=True):
    from asgart_tpu_torch.index import CODE

    n4 = -(-n1 // 4)
    exc = [q * n4 + d for q in range(1, 4) for d in (-1, 0)] \
        if exc_quarters else []
    g, (packed, exc_pos, exc_code) = _strand(rng, n1, exc)
    p = _view(packed, pmis)
    got = model_unpack(p.numpy(), n1, p.data_ptr() % 16, cmis)
    got[exc_pos] = exc_code  # the second launch
    want = codes_mod.unpack_codes_plain(
        p, torch.from_numpy(exc_pos), torch.from_numpy(exc_code), n1)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got, CODE[g])


@pytest.mark.parametrize("r", range(64))
def test_ki_model_around_a_tile_edge(r):
    """n1 at every residue mod 64 around the end of the first tile (so n4 %
    4 and n4 % 16 take every value), for packed at offsets 0 and 5 and
    codes at 0, 3 and 15: exceptions at each quarter's first position and
    the one before, and '$' at n1 - 1."""
    rng = np.random.default_rng(r)
    for pmis in (0, 5):
        n1 = 4 * (KI_TILE - pmis) - 32 + r
        for cmis in (0, 3, 15):
            _hold_ki(n1, pmis, cmis, rng)


@pytest.mark.parametrize("mis", range(1, 16))
def test_ki_model_misaligned_views(mis):
    """``packed`` and ``codes`` as views at byte offsets 1-15 (each with a
    different codes offset), on a strand of three tiles and a part."""
    rng = np.random.default_rng(100 + mis)
    n1 = 4 * 3 * KI_TILE + 4 * mis + 1
    _hold_ki(n1, mis, (7 * mis) % 16, rng)
    _hold_ki(n1 + 2, (16 - mis) % 16, mis, rng)


def test_ki_model_short_strands():
    """n1 from 1 to 40 (n1 < 16: every position in edge bytes) at several
    alignments."""
    rng = np.random.default_rng(3)
    for n1 in range(1, 41):
        for pmis, cmis in ((0, 0), (15, 1), (8, 13)):
            _hold_ki(n1, pmis, cmis, rng, exc_quarters=n1 >= 8)


# --- the launches with the library faked -----------------------------------

class _Lib:
    def __init__(self):
        self.calls = []

    def asgart_gather_owned(self, *a):
        self.calls.append(("gather_owned", a))
        return 0

    def asgart_unpack_codes(self, *a):
        self.calls.append(("unpack_codes", a))
        return 0


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


@pytest.mark.parametrize("total", [0, 7])
def test_gather_owned_launch(monkeypatch, total):
    """One launch a call, with the lanes' count, the rank's rows and the
    buffer; nothing launched for an empty buffer."""
    lib = _Lib()
    _fake(monkeypatch, lib)
    lo = torch.tensor([0, 2, 4], dtype=torch.int32)
    hi = torch.tensor([2, 2 + (total > 0) * 5, 4], dtype=torch.int32)
    mask = torch.tensor([total > 0, True, False])
    off, t = sharded.csr_offsets(lo, hi, mask)
    assert t == total
    sa = torch.arange(3, dtype=torch.int32)
    before = sharded.gather_owned.launches
    flat = sharded.gather_owned(lo, hi, mask, off, t, sa, 1)
    assert flat.shape == (total,) and flat.dtype == torch.int32
    assert sharded.gather_owned.launches == before + (total > 0)
    if total == 0:
        assert not lib.calls
        return
    (name, a), = lib.calls
    assert name == "gather_owned"
    assert a[4] == 3 and a[6:8] == (1, 3)  # n, row0, n_local
    assert a[8] == flat.data_ptr()


@pytest.mark.parametrize("n1", [0, 1, 17, 4 * KI_TILE + 3])
def test_unpack_codes_launch(monkeypatch, n1):
    """One launch a call with n4 = ceil(n1 / 4), n1 and the exceptions'
    count; nothing launched for n1 = 0."""
    lib = _Lib()
    _fake(monkeypatch, lib)
    n4 = -(-n1 // 4)
    packed = torch.zeros(n4, dtype=torch.uint8)
    n_exc = min(n1, 2)
    pos = torch.arange(n_exc, dtype=torch.int64)
    code = torch.zeros(n_exc, dtype=torch.uint8)
    before = codes_mod.unpack_codes.launches
    out = codes_mod.unpack_codes(packed, pos, code, n1)
    assert out.shape == (n1,) and out.dtype == torch.uint8
    assert codes_mod.unpack_codes.launches == before + (n1 > 0)
    if n1 == 0:
        assert not lib.calls
        return
    (name, a), = lib.calls
    assert name == "unpack_codes"
    assert a[1:3] == (n4, n1) and a[5] == n_exc and a[6] == out.data_ptr()


# --- the caller's total ----------------------------------------------------

def test_csr_offsets_takes_the_callers_total(monkeypatch):
    """With the total given, csr_offsets reads nothing back; without it,
    the total is the masked lanes' summed lengths."""
    lo = torch.tensor([0, 3, 5, 9], dtype=torch.int32)
    hi = torch.tensor([2, 3, 9, 12], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True])
    off, total = sharded.csr_offsets(lo, hi, mask)
    assert total == 5 and off.tolist() == [0, 2, 2, 2]

    def no_read(self):
        raise AssertionError("the total was read back")

    monkeypatch.setattr(torch.Tensor, "__int__", no_read)
    off2, total2 = sharded.csr_offsets(lo, hi, mask, 5)
    assert total2 == 5 and torch.equal(off2, off)


@pytest.mark.parametrize("budget", [None, "4"])
def test_scan_lanes_hands_gather_the_chunk_total(monkeypatch, budget):
    """scan_lanes hands the gather each whole chunk's exact total (stage
    1's), and None for the slices of a chunk past the slice budget."""
    from types import SimpleNamespace

    from asgart_tpu_torch.structs import RunSettings

    if budget is None:
        monkeypatch.delenv("ASGART_DEVICE_SLICE_LANES", raising=False)
    else:
        monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", budget)
    monkeypatch.setattr(device_engine, "SLICE_GRAN", 2)
    lo = torch.tensor([0, 2, 4, 1, 0, 3], dtype=torch.int32)
    hi = torch.tensor([3, 2, 7, 4, 2, 4], dtype=torch.int32)
    mask = torch.tensor([True, True, True, False, True, True])
    specs = ((0, 100, 4), (200, 100, 2))
    totals = [6, 3]
    lanes = SimpleNamespace(lane_lo=lo, lane_hi=hi, lane_mask=mask,
                            specs=specs,
                            offs={(0, 100): (0, 6), (200, 100): (4, 3)})
    seen = []
    sa = torch.arange(8, dtype=torch.int32)

    def gather(lo_s, hi_s, mask_s, total):
        seen.append((lo_s.numel(), total))
        return lo_s, hi_s, sa

    for res in device_engine.scan_lanes(
            RunSettings(probe_size=4), lanes, None,
            [(0, 100), (200, 100)], lambda cs, cl: (0, cs, cs + cl),
            gather=gather):
        if isinstance(res, device_engine.Sliced):
            list(res)  # the slices' scans, in order
    if budget is None:
        assert seen == list(zip((4, 2), totals))
    else:  # chunk 0 (total 6) sliced in two; chunk 1 (3) whole
        assert len(seen) == 3
        assert [t for _, t in seen[:-1]] == [None] * (len(seen) - 1)
        assert sum(n for n, _ in seen[:-1]) == 4
        assert seen[-1] == (2, 3)
