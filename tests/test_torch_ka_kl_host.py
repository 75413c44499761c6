"""The host side and the tile arithmetic of KA ``pack_keys`` and of KL
``full_round_refine``, on the CPU:

- a numpy model of KA's kernel (csrc/pack_keys.cu) tile by tile: the
  same tiles (``KA_DIRECT_TILE`` rows, ``KA_PROBE_TILE`` lanes of one
  chunk from :func:`probe_tiles`), the same staging of each tile's codes
  in 16-byte lines aligned in the address space (at most two affine
  segments a tile, reversed for -R, complemented by the byte-permute
  table, zeros past W - 1, W or the probe source), the same rolling
  shifts (one symbol a row, k // 2 a lane; a 3k-bit word or a (hi, lo)
  pair) and the same swizzled staging slots, held exactly to
  ``pack_keys_plain`` at its edges: rows 0, T - 1, T, T + 1 and W - 1 at
  the '$', the doubled text around n1 and 2 n1 - 1, chunks whose tiles
  end mid-chunk and lanes past ``lane_off[-1]`` (pad rows), -R, -C and
  -RC, k = 2, 10, 11, 20, 21, 25, 30, and codes at several alignments;
- :func:`probe_tiles` at its edges, and KA's launch with the library
  faked: one table of lane offsets, tile offsets and (x0, cl) pairs, the
  live tiles and lanes, one launch counted a call;
- KL's launch with the library faked: its in-order pass, then KC's
  scatter with M = W = n on the scratch of ``kc_plan(n, n)``, the run
  starts in that plan's plane; nothing launched at n = 0; no tensor made
  beyond new_sa, tied and the scratch; KL's launch counted, KC's not.

The kernels themselves are held to their plain versions on the GPU
(tests/test_torch_cuda.py). Exact (integers)."""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from asgart_tpu_torch.kernels import _build

from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

pk = importlib.import_module("asgart_tpu_torch.kernels.pack_keys")
ties = importlib.import_module("asgart_tpu_torch.kernels.ties")
invert = importlib.import_module("asgart_tpu_torch.kernels.invert")

PER_D, PER_P = 8, 4  # csrc/pack_keys.cu kDirectPer, kProbePer
THREADS = 256
LO30 = (1 << 30) - 1
# the byte permute's table: kComp = {0, 5, 3, 2, 4, 1, 0, 0}
KCOMP = np.array([0, 5, 3, 2, 4, 1, 0, 0], dtype=np.uint8)


# --- a numpy model of csrc/pack_keys.cu -----------------------------------

def stage(codes, mis0, pb, pe, ve, a, rev, comp, base):
    """(the staged bytes from slot ``base``, off): slot i + off holds tile
    position i, as the kernel's stage(); ``mis0`` is the codes' address
    mod 16."""
    if pe <= pb:
        return np.zeros(0, np.uint8), 0
    n1 = len(codes)
    mis = (mis0 + a) % 16
    delta = 15 - mis if rev else mis
    A0 = a - mis
    lines = (delta + (pe - pb) + 15) >> 4
    off = base + delta - pb
    out = np.zeros(16 * lines, np.uint8)
    for ln in range(lines):
        A = A0 - 16 * ln if rev else A0 + 16 * ln
        idx = np.arange(A, A + 16)
        ok = (idx >= 0) & (idx < n1)
        v = np.where(ok, codes[np.clip(idx, 0, max(n1 - 1, 0))], 0)
        if rev:
            v = v[::-1]
        if comp:
            v = KCOMP[v & 7]
        p0 = base + 16 * ln - off
        pos = p0 + np.arange(16)
        v = np.where((pos >= pb) & (pos < ve), v, 0)
        out[16 * ln:16 * ln + 16] = v
    return out, off


def slot8(m, per):
    return m ^ ((m >> 4) & (per - 1))


def slot4(m, per):
    return m ^ ((m >> 5) & (per - 1))


def roll_tile(sym, cnt, k, per, stride, words):
    """The keys' (hi, lo) of the tile's ``cnt`` rows as the kernel's
    threads roll them: thread t takes rows [per t, per (t + 1)); row m's
    first symbol is at m * stride; vectorized over the threads."""
    m0 = np.arange(0, cnt, per, dtype=np.int64)
    hmask = (1 << (3 * (k if words == 1 else k - 10))) - 1
    hi = np.zeros(len(m0), dtype=object)
    lo = np.zeros(len(m0), dtype=object)

    def push(s):
        nonlocal hi, lo
        s = s.astype(object)
        if words == 1:
            lo = ((lo << 3) | s) & hmask
        else:
            hi = ((hi << 3) | (lo >> 27)) & hmask
            lo = ((lo << 3) | s) & LO30

    first = k - 1 if stride == 1 else k
    for t in range(first):
        push(sym(m0 * stride + t))
    his, los = [], []
    for i in range(per):
        m = m0 + i
        if i > 0 and stride > 1:
            for t in range(stride):
                push(sym(np.minimum(m, cnt - 1) * stride + k - stride + t))
        if stride == 1:
            push(sym(np.minimum(m, cnt - 1) + k - 1))
        if words == 1:
            his.append(lo >> 30)
            los.append(lo & LO30)
        else:
            his.append(hi)
            los.append(lo)
    his = np.stack(his, 1).reshape(-1)[:cnt]
    los = np.stack(los, 1).reshape(-1)[:cnt]
    return his, los


def staged_out(values, cnt, per, slot):
    """Rows [0, cnt) through the swizzled staging slots, as the kernel
    writes them and reads them back out; the slots of a whole tile are a
    permutation of it."""
    T = THREADS * per
    assert sorted(slot(np.arange(T), per).tolist()) == list(range(T))
    st = np.zeros(T, dtype=object)
    st[slot(np.arange(cnt), per)] = values
    return st[slot(np.arange(cnt), per)]


def words_of(hi, lo, flag, words):
    if words == 1:
        return [(hi << 31) | (lo << 1) | flag]
    return [((hi >> 30) << 31) | (hi & LO30), (lo << 1) | flag]


def model_pack_keys(codes, mis0, lane_off, x0s, cls, k, reverse,
                    complement, W, total, ws=0, doubled=False):
    """KA's kernel, tile by tile: the same outputs as ``pack_keys``."""
    n1 = len(codes)
    words = pk.key_words(k)
    keys = [np.zeros(W + total, dtype=object) for _ in range(words)]
    mask = np.zeros(total, dtype=bool)
    T = pk.KA_DIRECT_TILE
    for r0 in range(0, W, T):
        cnt = min(T, W - r0)
        L = cnt + k - 1

        def cl_(x):
            return min(max(x, 0), L)

        if not doubled:
            segs = [(0, L, cl_(W - 1 - r0), ws + r0, 0, 0)]
        else:
            p1 = cl_(n1 - r0)
            a = r0 + p1 - n1
            segs = [(0, p1, p1, r0, 0, 0),
                    (p1, L, cl_(W - r0), n1 - 2 - a if reverse else a,
                     int(reverse), int(complement))]
        buf, offs, base = [], [], 0
        for sg in segs:
            b, off = stage(codes, mis0, *sg, base)
            buf.append(b)
            offs.append(off)
            base += len(b)
        buf = np.concatenate(buf)
        p1 = segs[0][1]

        def sym(i):
            return buf[i + np.where(i < p1, offs[0], offs[-1])]

        hi, lo = roll_tile(sym, cnt, k, PER_D, 1, words)
        flag = np.array([int(doubled and r0 + m >= n1) for m in range(cnt)],
                        dtype=object)
        for w, v in zip(keys, words_of(hi, lo, flag, words)):
            w[r0:r0 + cnt] = staged_out(v, cnt, PER_D, slot8 if w is keys[0]
                                        else slot4)
    step = k // 2
    tiles = pk.probe_tiles(lane_off)
    n_live = lane_off[-1]
    transformed = reverse or complement
    for tile in range(tiles[-1]):
        c = max(i for i in range(len(x0s)) if tiles[i] <= tile)
        j0 = (tile - tiles[c]) * pk.KA_PROBE_TILE
        lane0 = lane_off[c] + j0
        cnt = min(pk.KA_PROBE_TILE, lane_off[c + 1] - lane_off[c] - j0)
        L = (cnt - 1) * step + k
        qb = x0s[c] + j0 * step
        qmax = n1 - 1 if transformed else n1
        ve = min(max(qmax - qb, 0), L)
        buf, off = stage(codes, mis0, 0, L, ve,
                         n1 - 2 - qb if reverse else qb, int(reverse),
                         int(complement), 0)

        def sym(i):
            return buf[i + off]

        hi, lo = roll_tile(sym, cnt, k, PER_P, step, words)
        lo = np.minimum(lo, LO30)
        for w, v in zip(keys, words_of(hi, lo, 1, words)):
            w[W + lane0:W + lane0 + cnt] = staged_out(
                v, cnt, PER_P, slot8 if w is keys[0] else slot4)
        m = np.arange(cnt)
        mask[lane0:lane0 + cnt] = (buf[m * step + off] != 4) & (
            (j0 + m) * step < cls[c] - k - step)
    if words == 1:
        keys[0][W + n_live:] = pk.PAD_KEY
    else:
        keys[0][W + n_live:], keys[1][W + n_live:] = pk.PAD_KEY2
    return keys, mask


# --- the model against the plain version ----------------------------------

def _codes(rng, n, n_runs=(3, 0)):
    """Genome codes (A, C, G, T and a few N runs) then the '$'."""
    g = rng.choice(np.array([1, 2, 3, 5], dtype=np.uint8), n)
    for _ in range(n_runs[0]):
        a = int(rng.integers(0, n))
        g[a:a + int(rng.integers(1, 40))] = 4
    return np.concatenate([g, [0]]).astype(np.uint8)


def _specs(n1, k, counts, gap=17, start=5):
    """Back-to-back chunks of ``counts`` lanes each (a chunk's length
    gives exactly its lanes), ``gap`` bases apart."""
    step = k // 2
    specs, pos = [], start
    for nc in counts:
        cl = nc * step + k + step
        assert pos + cl < n1 - 1
        specs.append((pos, cl, nc))
        pos += cl + gap
    return tuple(specs)


def _hold(codes, specs, k, r, c, W, total, ws=0, doubled=False, mis0=0):
    n1 = len(codes)
    tabs = pk.chunk_tables(specs, n1, k, r, c)
    got, gmask = model_pack_keys(codes, mis0, *tabs, k, r, c, W, total, ws,
                                 doubled)
    want, wmask = pk.pack_keys_plain(torch.from_numpy(codes), *tabs, k, r, c,
                                     W, total, ws, doubled)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a.astype(np.int64), b.numpy())
    assert np.array_equal(gmask, wmask.numpy())


TRANSFORMS3 = [(True, False), (False, True), (True, True)]  # -R, -C, -RC


@pytest.mark.parametrize("k", [2, 10, 11, 20, 21, 25, 30])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS3)
def test_model_direct_and_doubled(k, reverse, complement):
    """Direct tiles: the whole genome (W = n1: rows 0, T - 1, T, T + 1 and
    W - 1 at the '$') and a trim window whose last tile is one row; the
    doubled text (2 n1 - 1 rows: the tile holding n1, the appended half's
    reversed, complemented reads up to 2 n1 - 1); the codes at an odd
    address."""
    rng = np.random.default_rng(k * 7 + 2 * reverse + complement)
    T = pk.KA_DIRECT_TILE
    codes = _codes(rng, 2 * T + 1 + 3 * k)
    n1 = len(codes)
    for mis0 in (0, 7):
        _hold(codes, (), k, reverse, complement, n1, 0, mis0=mis0)
        _hold(codes, (), k, reverse, complement, T + 1, 0, 11, mis0=mis0)
    _hold(codes, (), k, reverse, complement, 2 * n1 - 1, 0, doubled=True,
          mis0=3)


@pytest.mark.parametrize("k", [2, 10, 11, 20, 21, 25, 30])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS3 + [(False,
                                                                False)])
def test_model_probe_lanes(k, reverse, complement):
    """Probe tiles: chunks of 1023, 3, 1025 and 1024 lanes (tiles that end
    mid-chunk, a one-lane tile, a tile whose chunk fills it), pad rows past
    ``lane_off[-1]`` (a full pad tile and a partial one), a fused build
    with direct rows before them, N runs (masked lanes), and the last
    chunk's probes reading past the probe source (zeros)."""
    rng = np.random.default_rng(k * 11 + 2 * reverse + complement)
    step = k // 2
    counts = (1023, 3, 1025, 1024)
    need = sum(nc * step + k + step + 17 for nc in counts) + 10
    codes = _codes(rng, need + k, (6, 0))
    n1 = len(codes)
    specs = _specs(n1, k, counts)
    live = sum(counts)
    _hold(codes, specs, k, reverse, complement, 0, live + 1025, mis0=5)
    _hold(codes, specs, k, reverse, complement, n1, live + 3)
    # more lanes than a chunk's length holds, at each end of the genome:
    # one of them reads past the probe source (zeros, masked lanes)
    tail = ((5, 100, 1025), (n1 - 151, 100, 1025))
    _hold(codes, tail, k, reverse, complement, 0, 2050, mis0=9)


def test_model_probe_window_and_empty():
    """A fused trim window (W rows from ws, then lanes); no chunk (every
    lane a pad row); W = 1 (only the '$' row)."""
    rng = np.random.default_rng(3)
    codes = _codes(rng, 30_000)
    k = 20
    specs = _specs(len(codes), k, (700, 1500))
    _hold(codes, specs, k, True, True, 4097, 2200 + 7, 333, mis0=1)
    _hold(codes, (), k, True, True, 0, 2050)
    _hold(codes, (), k, False, False, 1, 0, 5)


# --- probe_tiles and the faked launches ------------------------------------

@pytest.mark.parametrize("counts,want", [
    ((), [0]), ((1,), [0, 1]), ((1024,), [0, 1]), ((1025,), [0, 2]),
    ((0, 1023, 0, 2048, 1), [0, 0, 1, 1, 3, 4]),
    ((4096, 1, 1025), [0, 4, 5, 7])])
def test_probe_tiles(counts, want):
    """Each chunk takes ceil(lanes / 1024) tiles of its own (an empty chunk
    none); the last entry is the live tiles' count."""
    lane_off = np.concatenate([[0], np.cumsum(counts)]).astype(int).tolist()
    assert pk.probe_tiles(lane_off) == want
    assert pk.KA_PROBE_TILE == 1024 and pk.KA_DIRECT_TILE == 2048


class _Lib:
    def __init__(self):
        self.calls = []

    def asgart_pack_keys(self, *a):
        (codes, n1, lane_off, tile_off, x0cl, n_chunks, live_tiles, n_live,
         W, ws, total, k, r, c, doubled, key, key_lo, mask, stream) = a
        words = lambda p, n: list(  # noqa: E731
            (ctypes.c_int64 * n).from_address(p))
        self.calls.append(dict(
            lane_off=words(lane_off, n_chunks + 1),
            tile_off=words(tile_off, n_chunks + 1),
            x0cl=words(x0cl, 2 * n_chunks), n_chunks=n_chunks,
            live=(live_tiles, n_live), shape=(W, ws, total, k),
            key_lo=key_lo))
        return 0

    def asgart_full_round_refine(self, *a):
        self.calls.append(("order", a))
        return 0

    def asgart_invert_fused(self, *a):
        self.calls.append(("scatter", a))
        return 0


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


@pytest.mark.parametrize("k", [20, 25])
def test_pack_keys_launch_table(monkeypatch, k):
    """One launch a call with one table: lane offsets, tile offsets, (x0,
    cl) pairs; the live tiles and lanes; key_lo only with two words."""
    lib = _Lib()
    _fake(monkeypatch, lib)
    codes = torch.zeros(200_000, dtype=torch.uint8)
    n1 = codes.numel()
    specs = ((10, 30_000, 2_000), (40_000, 50, 1), (60_000, 21_000, 1024))
    before = pk.pack_keys.launches
    pk.pack_keys(codes, specs, k, True, True, n1, 4000)
    assert pk.pack_keys.launches == before + 1
    (c,) = lib.calls
    lane_off, x0s, cls = pk.chunk_tables(specs, n1, k, True, True)
    assert c["lane_off"] == lane_off == [0, 2000, 2001, 3025]
    assert c["tile_off"] == pk.probe_tiles(lane_off) == [0, 2, 3, 4]
    assert c["x0cl"] == [v for p in zip(x0s, cls) for v in p]
    assert c["live"] == (4, 3025) and c["shape"] == (n1, 0, 4000, k)
    assert (c["key_lo"] is None) == (k <= 20)


@pytest.mark.parametrize("n", [0, 1, (1 << 13) - 1, (1 << 13) + 1,
                               (1 << 21) + 5])
def test_full_round_refine_launch(monkeypatch, n):
    """KL: its in-order pass writes new_sa, tied and the run starts into the
    l2 plane of kc_plan(n, n); then KC's entry scatters rank[new_sa] = s
    with M = W = n on that plan (no lane mask, no chunk, no lane planes);
    only new_sa, tied and the scratch are made; KL counts one launch and
    KC none; nothing is launched at n = 0."""
    lib = _Lib()
    _fake(monkeypatch, lib)
    made = []
    real = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **kw: made.append((a, kw.get("dtype")))
                        or real(*a, **kw))
    skey = torch.zeros(n, dtype=torch.int64)
    order = torch.zeros(n, dtype=torch.int64)
    rank = torch.zeros(n, dtype=torch.int32)
    before = (ties.full_round_refine.launches, invert.invert_fused.launches)
    new_sa, tied = ties.full_round_refine(skey, order, rank, 5)
    after = (ties.full_round_refine.launches, invert.invert_fused.launches)
    assert after == (before[0] + (n > 0), before[1])
    assert new_sa.dtype == torch.int32 and tied.dtype == torch.bool
    assert new_sa.shape == tied.shape == (n,)
    if n == 0:
        assert not lib.calls
        return
    p = invert.kc_plan(n, n)
    assert [dt for _, dt in made] == [torch.int32, torch.bool, torch.int32]
    assert made[2][0] == (p.words,)
    (tag1, a1), (tag2, a2) = lib.calls
    assert (tag1, tag2) == ("order", "scatter")
    sp = a2[9]  # the scratch: its cursors first
    l2 = sp + 4 * p.l2_at
    (skey_p, order_p, n1, bound, new_sa_p, run_start, tied_p, _) = a1
    assert (skey_p, order_p, n1, bound) == (
        skey.data_ptr(), order.data_ptr(), n, 5)
    assert (new_sa_p, run_start, tied_p) == (new_sa.data_ptr(), l2,
                                             tied.data_ptr())
    (sa2, run_lo, run_hi, mask, M, W, off, n_chunks, cap, cursor, coarse,
     tiles, d1, l1, h1, h1_first, d2, l2_, h2, h2_first, rank_p, lane_lo,
     lane_hi, totals, _) = a2
    assert (sa2, run_lo, run_hi) == (new_sa.data_ptr(), l2, l2)
    assert (M, W, n_chunks, mask, off, cap) == (n, n, 0, None, None, 0)
    assert (coarse, tiles) == (p.coarse, p.tiles)
    assert (d1, l1, d2, l2_) == tuple(sp + 4 * w for w in (
        p.d1_at, p.l1_at, p.d2_at, p.l2_at))
    assert p.h1_at == p.h2_at == 0
    assert (h1, h1_first, h2, h2_first) == (None, 0, None, 0)
    assert rank_p == rank.data_ptr()
    assert (lane_lo, lane_hi, totals) == (None, None, None)
