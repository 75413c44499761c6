"""The host side of KJ ``invert_tables`` (the table form of KC's
partitioned scatter) and of KH ``mj_ranges``' key directory, on the CPU:

- KJ's scratch, :func:`kc_plan` with no direct row (every plane of n
  slots, 16-byte aligned, apart), and its launch with the kernel library
  faked (the inputs reported as GPU tensors, each entry point a Python
  function that records its arguments): the plan's planes, no lane mask
  and no totals made, KJ's launch counted and KC's not;
- the directory's plain version (``mj_directory_plain``, by
  ``torch.searchsorted`` over the bucket boundaries) against a
  brute-force walk with its own digit rule: W = 1, every key in one
  bucket, empty buckets, keys holding N and '$' ranks, k below the
  directory's symbols, k = 2 and k = 20, a shard ``key[a:b]``; every
  key equal to a probe lies in the probe's bucket, and the rows before
  and after it are below and above the probe;
- KH's and the directory's launches with the library faked (the chunk
  offsets on the device, the directory's pointer, bits and k); the
  directory's size rule; the window index builds its directory once,
  counts it in ``nbytes()``, and a warm rescan does not rebuild it; on
  the CPU it builds none, since KH's plain version reads none; KH's
  wrapper on the CPU, given a directory, against the JAX ``_mj_tail``
  (the same lanes as tests/test_torch_merge_join.py).

The directory search itself runs only in the kernel.

The kernels themselves are held to their plain versions on the GPU
(tests/test_torch_cuda.py). Exact (integers)."""

import ctypes
import importlib

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu import device_engine as de
from asgart_tpu_torch.kernels import _build

from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

invert = importlib.import_module("asgart_tpu_torch.kernels.invert")
tables = importlib.import_module("asgart_tpu_torch.kernels.tables")
mj = importlib.import_module("asgart_tpu_torch.kernels.merge_join")


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


@pytest.mark.parametrize("M", [1, (1 << 13) - 1, (1 << 13) + 1,
                               (1 << 21) + 5])
def test_kc_plan_table_form(M):
    """kc_plan(M, 0): every row a lane, so each pass has three planes of M
    slots (run_hi's from slot 0), after the cursors, 16-byte aligned and
    apart."""
    p = invert.kc_plan(M, 0)
    assert (p.coarse, p.tiles) == (-(-M // (1 << 21)), -(-M // (1 << 13)))
    assert p.h1_first == p.h2_first == 0
    planes = sorted((p.d1_at, p.l1_at, p.h1_at, p.d2_at, p.l2_at, p.h2_at))
    assert planes[0] >= p.coarse + p.tiles
    for a, b in zip(planes, planes[1:] + [p.words]):
        assert a % 4 == 0 and b - a >= M
    assert p.words - planes[-1] < M + 4


class _KjLib:
    def __init__(self):
        self.calls = []

    def asgart_invert_tables(self, *a):
        (sa, lo, hi, n, cursor, coarse, tiles, d1, l1, h1, d2, l2, h2,
         pos_lo, pos_hi, rank, step, stream) = a
        self.calls.append(dict(n=n, counts=(coarse, tiles), step=step,
                               planes=(cursor, d1, l1, h1, d2, l2, h2),
                               outs=(pos_lo, pos_hi, rank)))
        return 0


@pytest.mark.parametrize("n", [0, 1, 8193, 50_000])
def test_invert_tables_launch(monkeypatch, n):
    """KJ's table form gets the plan's planes and its three outputs; no
    bool (lane mask) or int64 (totals, offsets) tensor is made; one KJ
    launch is counted (none for no row) and no KC launch."""
    lib = _KjLib()
    _fake(monkeypatch, lib)
    made = []
    real = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: made.append(k.get("dtype"))
                        or real(*a, **k))
    sa = torch.arange(n, dtype=torch.int32)
    before = (tables.invert_tables.launches, invert.invert_fused.launches)
    pos_lo, pos_hi, rank = tables.invert_tables(sa, sa.clone(), sa.clone(),
                                                1)
    after = (tables.invert_tables.launches, invert.invert_fused.launches)
    assert after == (before[0] + (n > 0), before[1])
    assert set(made) <= {torch.int32}
    assert pos_lo.shape == pos_hi.shape == rank.shape == (n,)
    if n == 0:
        assert not lib.calls
        return
    (c,) = lib.calls
    p = invert.kc_plan(n, 0)
    assert c["n"] == n and c["counts"] == (p.coarse, p.tiles)
    assert c["step"] == 1  # the planes in position order
    cursor = c["planes"][0]
    assert [x - cursor for x in c["planes"][1:]] == [
        4 * w for w in (p.d1_at, p.l1_at, p.h1_at, p.d2_at, p.l2_at,
                        p.h2_at)]
    assert c["outs"] == (pos_lo.data_ptr(), pos_hi.data_ptr(),
                         rank.data_ptr())


# --- KH's key directory ---------------------------------------------------

def _bucket_walk(v: int, k: int, bits: int) -> int:
    """A key's bucket, one symbol at a time: its first ceil(bits / 2)
    symbols as 2-bit digits ('$' and A 0, C 1, G and N 2, T 3), every
    digit after a '$' 0 and after an N 3; the string's top ``bits``
    bits."""
    m = (bits + 1) // 2
    digit = {0: 0, 1: 0, 2: 1, 3: 2, 4: 2, 5: 3}
    out, fill = [], None
    for t in range(m):
        r = (v >> (3 * (k - 1 - t))) & 7
        out.append(digit[r] if fill is None else fill)
        if fill is None and r in (0, 4):
            fill = 0 if r == 0 else 3
    d = 0
    for x in out:
        d = (d << 2) | x
    return d >> (2 * m - bits)


def _keys(rng, k, W, alphabet):
    syms = rng.choice(alphabet, size=(W, k))
    v = np.zeros(W, dtype=np.int64)
    for t in range(k):
        v = (v << 3) | syms[:, t]
    return np.sort(v) << 1


# (k, W, alphabet, rows [a, b) of the keys or None): W = 1 (no directory);
# every key one k-mer (one bucket); two symbols of four (empty buckets);
# '$' and N ranks with A and T; k below the directory's symbols; k = 2;
# k = 20; a shard of four
DIR_CASES = [(20, 1, (1, 2, 3, 5), None), (20, 3000, (5,), None),
             (20, 3000, (1, 5), None), (8, 4000, (0, 1, 4, 5), None),
             (12, 5000, (0, 1, 2, 3, 4, 5), None),
             (3, 4000, (1, 2, 3, 5), None), (2, 2000, (0, 1, 2, 3, 4, 5),
                                            None),
             (20, 20_000, (1, 2, 3, 5), None),
             (20, 20_001, (1, 2, 3, 5), (5001, 10_002))]


@pytest.mark.parametrize("k,W,alphabet,rows", DIR_CASES)
def test_mj_directory_plain_equals_walk(k, W, alphabet, rows):
    """The directory (2^bits + 1 entries, at most W / 16) equals a walk
    over the keys' buckets; every probe's equal keys lie inside its
    bucket, and the rows outside it compare below and above it."""
    rng = np.random.default_rng(W + k)
    key = _keys(rng, k, W, alphabet)
    if rows is not None:
        key = np.ascontiguousarray(key[rows[0]:rows[1]])
    n = len(key)
    d = mj.mj_directory(torch.from_numpy(key), k)
    if n < 48:
        assert d is None and mj.mj_directory_bits(n, k) == 0
        return
    assert d.bits == mj.mj_directory_bits(n, k) and d.W == n
    nb = 1 << d.bits
    assert 1 <= d.bits <= 2 * k and nb + 1 <= n // 16
    v = (key >> 1).tolist()
    b = [_bucket_walk(x, k, d.bits) for x in v]
    assert b == sorted(b)  # non-decreasing along the sorted keys
    want, i = [], 0
    for bucket in range(nb + 1):
        while i < n and b[i] < bucket:
            i += 1
        want.append(i)
    assert d.table.tolist() == want
    assert torch.equal(mj.bucket_of(torch.from_numpy(key >> 1), k, d.bits),
                       torch.tensor(b))
    table = d.table.numpy()
    probes = np.concatenate([_keys(rng, k, 500, (0, 1, 2, 3, 4, 5)) >> 1,
                             key[rng.integers(0, n, 500)] >> 1])
    for p in probes.tolist():
        pb = _bucket_walk(p, k, d.bits)
        s, e = table[pb], table[pb + 1]
        lo = int(np.searchsorted(key >> 1, p, side="left"))
        hi = int(np.searchsorted(key >> 1, p, side="right"))
        assert s <= lo <= hi <= e


def test_mj_directory_size_rule():
    """2^bits + 1 <= W // 16 and bits <= 2k; no directory below 48 rows;
    an explicit bits past that is refused."""
    assert mj.mj_directory_bits(47, 20) == 0
    assert mj.mj_directory_bits(48, 20) == 1
    assert mj.mj_directory_bits(32_000_001, 20) == 20
    assert mj.mj_directory_bits(32_000_001, 3) == 6
    for W in (48, 1000, 1 << 20, (1 << 31) - 1):
        bits = mj.mj_directory_bits(W, 20)
        assert (1 << bits) + 1 <= W // 16 < (1 << (bits + 1)) + 1
    with pytest.raises(ValueError, match="bits"):
        mj.mj_directory(torch.zeros(100, dtype=torch.int64), 20, 3)


def test_mj_directory_refuses_bad_keys():
    """Keys out of order or past k symbols raise, on the CPU as the kernel
    flags them on the card."""
    key = torch.from_numpy(_keys(np.random.default_rng(0), 20, 1000,
                                 (1, 2, 3, 5)))
    with pytest.raises(ValueError, match="below its predecessor"):
        mj.mj_directory(key.flip(0).contiguous(), 20)
    with pytest.raises(ValueError, match="outside k symbols"):
        mj.mj_directory(key, 8)


class _KhLib:
    def __init__(self):
        self.calls = []

    def asgart_mj_ranges(self, *a):
        (skey, W, pkey, mask, total, off, n_chunks, dir_, bits, k, lo, hi,
         totals, counts, stream) = a
        words = list((ctypes.c_int64 * (n_chunks + 1)).from_address(off))
        self.calls.append(dict(W=W, total=total, words=words, dir=dir_,
                               bits=bits, k=k, counts=counts))
        return 0

    def asgart_mj_directory(self, skey, W, k, bits, dir_, bad, stream):
        self.calls.append(dict(W=W, k=k, bits=bits, dir=dir_))
        ctypes.c_int32.from_address(bad).value = 0
        return 0


@pytest.mark.parametrize("n_chunks", [1, 256, 257])
def test_mj_ranges_launch(monkeypatch, n_chunks):
    """KH gets its chunk offsets in a tensor on the keys' device, the
    directory's table, bits and k (none without one), no counts; its
    directory one launch of its own."""
    rng = np.random.default_rng(n_chunks)
    key = torch.from_numpy(_keys(rng, 20, 5000, (1, 2, 3, 5)))
    d = mj.mj_directory(key, 20)  # (on the CPU: the plain version)
    lib = _KhLib()
    _fake(monkeypatch, lib)
    total = 3 * n_chunks
    pkey = key[:total] | 1
    mask = torch.ones(total, dtype=torch.bool)
    lane_off = list(range(0, total + 1, 3))
    before = (mj.mj_ranges.launches, mj.mj_directory.launches)
    mj.mj_ranges(key, pkey, mask, lane_off, d)
    mj.mj_ranges(key, pkey, mask, lane_off)
    dk = mj.mj_directory(key, 20)
    assert (mj.mj_ranges.launches, mj.mj_directory.launches) == \
        (before[0] + 2, before[1] + 1)
    c, c0, cd = lib.calls
    assert (c["W"], c["total"], c["counts"]) == (5000, total, None)
    assert c["words"] == lane_off
    assert (c["dir"], c["bits"], c["k"]) == (d.table.data_ptr(), d.bits, 20)
    assert (c0["dir"], c0["bits"]) == (None, 0)
    assert (cd["W"], cd["k"], cd["bits"]) == (5000, 20, d.bits)
    assert cd["dir"] == dk.table.data_ptr()
    assert dk.table.shape == ((1 << d.bits) + 1,)


def test_mj_ranges_refuses_other_directory():
    key = torch.from_numpy(_keys(np.random.default_rng(1), 20, 3000,
                                 (1, 2, 3, 5)))
    d = mj.mj_directory(key[:2000].contiguous(), 20)
    with pytest.raises(ValueError, match="directory"):
        mj.mj_ranges(key, key[:10] | 1, torch.ones(10, dtype=torch.bool),
                     [0, 10], d)


def test_window_index_directory_once(tmp_path, monkeypatch):
    """The merge-join window index builds its directory once (at most
    W / 16 words, in ``nbytes()``), and a warm rescan of the same chunks
    builds no other; a rank's shard holds its own keys' directory. (On
    the CPU the index builds none: the plain directory stands in for the
    kernel's here.)"""
    from asgart_tpu_torch import window_index
    from asgart_tpu_torch.device_engine import DeviceWindowEngine
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.window_index import ShardedWindowIndex
    from torch_jax_ref import chunked_genome, prepared

    built = []
    real = mj.mj_directory_plain

    def plain(key, k):
        bits = mj.mj_directory_bits(key.numel(), k)
        built.append((k, bits))
        return real(key, k, bits)

    monkeypatch.setattr(window_index, "index_directory", plain)
    _, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(probe_size=20)
    eng = DeviceWindowEngine(strand, s, torch.device("cpu"), (1000, 30000),
                             cache=None)
    eng.stage1(chunks)
    idx = eng.index
    W = idx.W
    assert built == [(20, mj.mj_directory_bits(W, 20))]
    assert idx.directory.table.numel() <= W // 16
    assert idx.nbytes() == 12 * W + 4 * idx.directory.table.numel() + \
        idx.stage1.nbytes()
    eng.stage1(chunks)
    assert len(built) == 1
    built.clear()
    sh = ShardedWindowIndex.build(strand.data, 20, (1000, 30000), False,
                                  False, torch.device("cpu"), 1, 4, False)
    assert built == [(20, sh.directory.bits)]
    assert sh.directory.W == sh.key.numel()
    assert torch.equal(sh.directory.table,
                       real(sh.key, 20, sh.directory.bits).table)


def test_window_index_no_directory_on_cpu(tmp_path):
    """On the CPU a window index and a shard hold no directory (KH's
    plain version co-sorts), and ``nbytes()`` counts none."""
    from asgart_tpu_torch.window_index import (DeviceWindowIndex,
                                               ShardedWindowIndex)
    from torch_jax_ref import chunked_genome, prepared

    _, _, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    cpu = torch.device("cpu")
    idx = DeviceWindowIndex.build(strand.data, 20, (1000, 30000), False,
                                  False, cpu)
    sh = ShardedWindowIndex.build(strand.data, 20, (1000, 30000), False,
                                  False, cpu, 1, 4, False)
    assert mj.mj_directory_bits(idx.W, 20) > 0
    for ix in (idx, sh):
        assert ix.directory is None
        assert ix.nbytes() == 12 * ix.key.numel()


def test_mj_ranges_on_cpu_given_directory_equals_mj_tail():
    """KH's wrapper on the CPU, given the keys' directory (which its
    plain version does not read), against the JAX ``_mj_tail`` on a
    repeat-heavy window and probes from it."""
    rng = np.random.default_rng(5)
    W, B = 4000, 3000
    syms = rng.integers(0, 2, (W, 10))
    hi = np.zeros(W, dtype=np.int32)
    lo = np.zeros(W, dtype=np.int32)
    for t in range(10):
        hi = (hi << 3) | (syms[:, t] + 1)
        lo = (lo << 3) | (syms[:, 9 - t] + 1)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    pick = rng.integers(0, W, B)
    phi, plo = hi[pick].copy(), lo[pick].copy()
    plo[::7] ^= 1  # some absent
    mask = rng.random(B) < 0.8
    want_lo, want_hi = (np.asarray(a) for a in de._mj_tail(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(phi),
        jnp.asarray(plo), jnp.asarray(mask)))
    key = torch.from_numpy((hi.astype(np.int64) << 31)
                           | (lo.astype(np.int64) << 1))
    pkey = torch.from_numpy((phi.astype(np.int64) << 31)
                            | (plo.astype(np.int64) << 1) | 1)
    d = mj.mj_directory(key, 20)
    assert d.bits > 0
    got_lo, got_hi, _ = mj.mj_ranges(key, pkey, torch.from_numpy(mask),
                                     [0, B], d)
    assert np.array_equal(got_lo.numpy(), want_lo)
    assert np.array_equal(got_hi.numpy(), want_hi)
