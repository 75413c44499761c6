"""KK ``full_round_keys`` in position order and KH's key directory
``mj_directory`` without block barriers or a host wait, on the CPU:

- the position-order full round (KK's keys of every position in position
  order, the stable sort, KL with the sort's permutation as the new
  order) against the JAX ``_full_round`` for 3 rounds from the table
  build's first tied state: seeded Alu-like repeats, direct and
  reverse-complement copies, homopolymers with N runs; k = 4, 12, 20, 25;
  every transform. The invariant the round rests on (within each run of
  equal rank the order ascends by position) is checked on that state and
  after every round; ``ties.full_rounds`` empties the order it was given;
- a numpy model of csrc/merge_join.cu's directory kernel, thread by
  thread and warp by warp (4 rows a thread, the predecessor from the lane
  before or, for lane 0, one load; the change rows, where a key's first
  symbols change, found by ballots; their buckets computed in rounds of
  one ``bucket_of`` a lane, each lane finding the change it serves by a
  binary search over the ballots and reading its key by shuffles; short
  runs stored by their thread, long ones by the warp; the grid-stride
  loop), held exactly to ``mj_directory_plain``
  with every word written once: W = 48, rows at thread, warp and block
  edges, long bucket runs, '$' and N, a shard, a small grid; keys out of
  order or past k symbols flagged;
- with the library faked: ``mj_directory`` makes no host read and hands
  its flag on; the engines' one read of the join's totals raises
  ``ValueError`` for a flagged directory before any range is kept (one
  device, the rank-sharded engine on one rank, the windows x probes mesh),
  and equals the run without a directory for a clean one.

The kernels themselves are held to their plain versions on the GPU
(tests/test_torch_cuda.py). Exact (integers)."""

import ctypes
from collections import Counter

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.kernels import _build
from asgart_tpu_torch.kernels import merge_join as mj

from torch_jax_ref import TRANSFORMS, chunked_genome, prepared
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import mutate, random_dna, revcomp

CPU = torch.device("cpu")
TEXT_LEN = 2400


def _text(kind: str, seed: int = 3) -> np.ndarray:
    """Genome + '$' of TEXT_LEN bases (one length: one JAX compile a
    transform's shape)."""
    rng = np.random.default_rng([seed, len(kind)])
    g = bytearray(random_dna(rng, TEXT_LEN))
    if kind == "repeats":  # 14 copies of a 60 bp element, 1.5% divergent
        el = random_dna(rng, 60)
        for c, at in enumerate(range(100, 2300, 160)):
            cp = mutate(rng, el, 0.015)
            g[at:at + 60] = revcomp(cp) if c % 3 == 2 else cp
    elif kind == "rc":  # a direct and a reverse-complement copy
        g[1200:1600] = bytes(g[100:500])
        g[1800:2200] = revcomp(bytes(g[100:500]))
    else:  # homopolymers and N runs
        g[200:260] = b"A" * 60
        g[700:760] = b"AT" * 30
        g[1000:1040] = b"N" * 40
        g[1500:1560] = b"T" * 60
        g[1900:1903] = b"NNN"
        g[2100:2140] = b"CG" * 20
    return np.frombuffer(bytes(g) + b"$", dtype=np.uint8)


def _first_tied_state(data, k, reverse, complement):
    """(sa, rank, tied, n, n1): the port's table build up to its ties, as
    ``DeviceIndex.build`` runs it (tests/test_torch_table_index.py holds
    each step to the JAX build)."""
    from asgart_tpu_torch.fused_index import probe_span, sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_tables,
                                          pack_keys)

    n1 = len(data)
    doubled = reverse or complement
    n = probe_span(n1, doubled)
    codes = torch.from_numpy(CODE[data])
    keys, _ = pack_keys(codes, (), k, reverse, complement, n, 0,
                        doubled=doubled)
    skeys, sa = sort_keys(keys)
    run_lo, run_hi, tied = group_bounds(skeys, sa, n1, flag_n_k=k,
                                        run_end=not doubled)
    _, _, rank = invert_tables(sa, run_lo, run_hi, k // 2)
    return sa, rank, tied, n, n1


def _assert_position_order(sa, rank):
    """Within each run of equal rank, ``sa`` ascends by position."""
    r = rank[sa.long()]
    same = r[1:] == r[:-1]
    assert bool((sa[1:][same] > sa[:-1][same]).all())


@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
@pytest.mark.parametrize("k", [4, 12, 20, 25])
@pytest.mark.parametrize("kind", ["repeats", "rc", "homopolymers"])
def test_position_order_round_equals_jax(kind, k, reverse, complement):
    """Three position-order rounds (KK, the stable sort, KL: the sort's
    permutation is the new order) against three JAX ``_full_round``s from
    the same first tied state: order, ranks and tied rows equal after each;
    the invariant holds before and after every round."""
    from asgart_tpu import device_index as di
    from asgart_tpu_torch.kernels import full_round_keys, full_round_refine

    data = _text(kind)
    sa, rank, tied, n, n1 = _first_tied_state(data, k, reverse, complement)
    assert bool(tied.any())
    _assert_position_order(sa, rank)
    # copies: the JAX round donates its inputs, and KL updates rank in place
    jsa, jrank = (jnp.array(t.numpy().copy()) for t in (sa, rank))
    h = k
    for _ in range(3):
        hh = min(h, n)
        jsa, jrank, jtied = di._full_round(jsa, jrank, jnp.int32(hh),
                                           jnp.int32(n1))
        key = full_round_keys(rank, hh, n1)
        skey, order = torch.sort(key, stable=True)
        sa, tied = full_round_refine(skey, order, rank, n1)
        assert np.array_equal(sa.numpy(), np.asarray(jsa))
        assert np.array_equal(rank.numpy(), np.asarray(jrank))
        assert np.array_equal(tied.numpy(), np.asarray(jtied))
        _assert_position_order(sa, rank)
        h *= 2


@pytest.mark.parametrize("kind", ["repeats", "homopolymers"])
def test_full_rounds_empty_the_order_they_replace(kind):
    """``ties.full_rounds`` runs its rounds from the ranks alone: the order
    and the tied rows it was given are emptied in place once a round runs
    (their memory free for the sort), the returned order keeps the
    invariant, and no round runs (nothing emptied) at or under the cap."""
    from asgart_tpu_torch import ties

    sa, rank, tied, n, n1 = _first_tied_state(_text(kind), 12, True, True)
    n_tied = int(tied.sum())
    keep = (sa.clone(), rank.clone(), tied.clone())
    got_sa, got_tied, h = ties.full_rounds(sa, rank, tied, 12, n_tied - 1,
                                           n1)
    assert sa.numel() == 0 and tied.numel() == 0
    assert got_sa.shape == got_tied.shape == (n,) and h >= 24
    assert int(got_tied.sum()) <= n_tied - 1
    _assert_position_order(got_sa, rank)
    sa, rank, tied = keep
    same = ties.full_rounds(sa, rank, tied, 12, n_tied, n1)
    assert same[0] is sa and same[1] is tied and same[2] == 12
    assert torch.equal(sa, keep[0]) and sa.numel() == n


# csrc/merge_join.cu's directory kernel, modelled thread by thread

KDIR_ROWS = 4  # kDirRows
LOW_BITS = 0x1249249249249249  # bit 0 of every 3-bit symbol field


def _bucket_kernel(v: int, k: int, bits: int) -> int:
    """csrc/merge_join.cu ``bucket_of``, bit for bit."""
    m = (bits + 1) >> 1
    x = v >> (3 * (k - m))
    d = 0
    for j in range(m - 1, -1, -1):
        r = (x >> (3 * j)) & 7
        d = (d << 2) | ((0xFE90 >> (2 * r)) & 3)
    ones = LOW_BITS & ((1 << (3 * m)) - 1)
    special = (~x & ~(x >> 1) & ones) | ((x >> 2) & (x >> 1) & ones)
    if special:
        j = (special.bit_length() - 1) // 3
        below = (1 << (2 * j)) - 1
        d = d & ~below if ((x >> (3 * j)) & 7) == 0 else d | below
    return d >> (2 * m - bits)


def _move_mask(s: int) -> int:
    """csrc/merge_join.cu ``move_mask``."""
    return sum(3 << (3 * j - (j & (s - 1))) for j in range(10) if j & s)


def _bucket_narrow(v: int, k: int, bits: int) -> int:
    """csrc/merge_join.cu ``bucket_narrow`` (bits <= 20), bit for bit."""
    ones32 = 0x09249249
    m = (bits + 1) >> 1
    x = (v >> (3 * (k - m))) & 0xFFFFFFFF
    r0, r1, r2 = x & ones32, (x >> 1) & ones32, (x >> 2) & ones32
    hi = r2 | (r1 & r0)
    d = (hi << 1) | (((r2 | r1) ^ hi) | (r2 & (r1 | r0)))
    for s in (1, 2, 4, 8):
        d = (d & ~_move_mask(s)) | ((d & _move_mask(s)) >> s)
    ones = ones32 & ((1 << (3 * m)) - 1)
    special = (~x & ~(x >> 1) & ones) | ((x >> 2) & (x >> 1) & ones)
    if special:
        j = (special.bit_length() - 1) // 3
        below = (1 << (2 * j)) - 1
        d = d & ~below if ((x >> (3 * j)) & 7) == 0 else d | below
    return d >> (2 * m - bits)


@pytest.mark.parametrize("k", [2, 5, 10, 11, 20])
def test_bucket_narrow_equals_bucket_of(k):
    """The directory's one-word bucket (every digit at once) equals
    ``bucket_of`` (a symbol at a time) at every bits up to 20, on keys of
    every symbol rank 0..7, '$', N and the unused 6 and 7 among them."""
    rng = np.random.default_rng(k)
    syms = rng.integers(0, 8, (3000, k))
    syms[:500] = rng.choice([0, 4, 6, 7], (500, k))
    v = np.zeros(3000, dtype=np.int64)
    for t in range(k):
        v = (v << 3) | syms[:, t]
    for bits in range(1, min(2 * k, 20) + 1):
        for x in v.tolist():
            assert _bucket_narrow(x, k, bits) == _bucket_kernel(x, k, bits)


def _changes_before(M, L):
    """Change rows in the lanes before lane L (``changes_before``)."""
    lt = (1 << L) - 1
    return sum(bin(m & lt).count("1") for m in M)


def _directory_model(key: np.ndarray, k: int, bits: int, threads=256,
                     max_blocks=132 * 32):
    """The directory kernel's launch (``grid_for((W + 4) / 4)`` blocks of
    ``threads``, at most ``max_blocks``) on the keys ``key`` (int64, flag
    bit 0): (table, flagged, words written per bucket, change rows,
    rounds of bucket_of on the warp's 32 lanes)."""
    R = KDIR_ROWS
    W = len(key)
    top = 1 << (3 * k)
    shift = 3 * (k - ((bits + 1) >> 1))
    vals = [int(x) >> 1 for x in key]
    blocks = max(1, min(max_blocks, -(-((W + R) // R) // threads)))
    warps = blocks * threads // 32
    table = [None] * ((1 << bits) + 1)
    written = Counter()
    wrong = False
    n_changes = rounds = 0

    def store(b, row):
        table[b] = row
        written[b] += 1

    for warp in range(warps):
        base = warp * 32 * R
        while base <= W:
            i0 = [base + ln * R for ln in range(32)]
            v = [[vals[i] if i < W else top for i in range(a, a + R)]
                 for a in i0]
            # lane 0 loads the key before the warp's rows; the others
            # take it from the lane before (__shfl_up_sync)
            p = [(vals[base - 1] if base > 0 else -1) if ln == 0
                 else v[ln - 1][R - 1] for ln in range(32)]
            mine = [0] * 32
            for ln in range(32):
                q = p[ln]
                for j in range(R):
                    if i0[ln] + j < W and (v[ln][j] < 0 or v[ln][j] >= top
                                           or q > v[ln][j]):
                        wrong = True
                    if (q >> shift) != (v[ln][j] >> shift):
                        mine[ln] |= 1 << j
                    q = v[ln][j]
            M = [sum(((mine[ln] >> j) & 1) << ln for ln in range(32))
                 for j in range(R)]
            T = sum(bin(m).count("1") for m in M)
            n_changes += T
            b_lo = [[1] * R for _ in range(32)]
            b_hi = [[0] * R for _ in range(32)]
            for r0 in range(0, T, 31):
                rounds += 1
                res = []
                for ln in range(32):  # the workers: item y on lane ln
                    y = r0 + ln
                    z = 0 if y == 0 else min(y - 1, T - 1)
                    L = 0  # (a shuffle of each lane's changes_before)
                    for step in (16, 8, 4, 2, 1):
                        if _changes_before(M, L + step) <= z:
                            L += step
                    f = mine[L]
                    for _ in range(z - _changes_before(M, L)):
                        f &= f - 1
                    jz = (f & -f).bit_length() - 1
                    w = [p[L]] + v[L]
                    kv = w[jz] if y == 0 else w[jz + 1]
                    res.append(-1 if kv < 0 else 1 << bits if kv >= top
                               else _bucket_narrow(kv, k, bits) if bits <= 20
                               else _bucket_kernel(kv, k, bits))
                for ln in range(32):  # the owners
                    t = _changes_before(M, ln)
                    for j in range(R):
                        if (mine[ln] >> j) & 1:
                            if r0 <= t < r0 + 31:
                                b_lo[ln][j] = res[t - r0] + 1
                                b_hi[ln][j] = res[t - r0 + 1]
                            t += 1
            for j in range(R):
                runs = [(b_lo[ln][j], b_hi[ln][j], i0[ln] + j)
                        for ln in range(32)]
                for lo, hi, i in runs:  # a short run by its thread
                    if hi - lo < 32:
                        for b in range(lo, hi + 1):
                            store(b, i)
                for lo, hi, i in runs:  # a long one by the warp (ballot)
                    if hi - lo >= 32:
                        for ln in range(32):
                            for b in range(lo + ln, hi + 1, 32):
                                store(b, i)
            base += warps * 32 * R
    return table, wrong, written, n_changes, rounds


def _keys(rng, k, W, alphabet):
    """W sorted one-word keys (flag 0) of k symbols from ``alphabet``."""
    syms = rng.choice(alphabet, size=(W, k))
    v = np.zeros(W, dtype=np.int64)
    for t in range(k):
        v = (v << 3) | syms[:, t]
    return np.sort(v) << 1


def _sparse_keys(rng, k, W):
    """W sorted keys of 5 values far apart in the key space: most buckets
    empty, long runs of them between the values."""
    v = np.sort(rng.integers(0, 1 << (3 * k), 5))
    return np.sort(v[rng.integers(0, 5, W)]) << 1


# (k, W, form, rows, threads, max_blocks): the least directory (48), rows
# at the thread (4), warp (128) and block (1024) edges, long bucket runs,
# '$' and N, k below the directory's symbols, a shard, a grid smaller
# than the rows (several grid-stride sweeps)
MODEL_CASES = [
    (12, 48, "acgt", None, 256, 4224), (20, 127, "acgt", None, 256, 4224),
    (20, 128, "acgt", None, 256, 4224), (20, 129, "sparse", None, 256, 4224),
    (20, 1023, "acgt", None, 256, 4224), (20, 1024, "sparse", None, 256,
                                          4224),
    (20, 1025, "dollar_n", None, 256, 4224),
    (8, 4000, "dollar_n", None, 256, 4224), (3, 3000, "acgt", None, 256,
                                             4224),
    (20, 20_001, "acgt", (5001, 10_002), 256, 4224),
    (20, 3001, "acgt", None, 64, 1), (12, 5000, "sparse", None, 32, 2)]


def _model_keys(k, W, form, rows):
    rng = np.random.default_rng([W, k])
    if form == "sparse":
        key = _sparse_keys(rng, k, W)
    else:
        key = _keys(rng, k, W, (0, 1, 2, 3, 4, 5) if form == "dollar_n"
                    else (1, 2, 3, 5))
    if rows is not None:
        key = np.ascontiguousarray(key[rows[0]:rows[1]])
    return key


@pytest.mark.parametrize("k,W,form,rows,threads,max_blocks", MODEL_CASES)
def test_directory_model_equals_plain(k, W, form, rows, threads,
                                      max_blocks):
    """The model of the kernel writes every directory word exactly once and
    equals ``mj_directory_plain``; its change rows are rows 0 and W and
    those whose first m symbols differ from their predecessor's, and each
    round of 32 bucket computations serves up to 31 of them."""
    key = _model_keys(k, W, form, rows)
    n = len(key)
    bits = mj.mj_directory_bits(n, k)
    table, wrong, written, changes, rounds = _directory_model(
        key, k, bits, threads, max_blocks)
    assert not wrong
    assert set(written) == set(range((1 << bits) + 1))
    assert set(written.values()) == {1}
    want = mj.mj_directory_plain(torch.from_numpy(key), k, bits)
    assert table == want.table.tolist()
    shift = 3 * (k - (bits + 1) // 2)
    v = key >> 1
    assert changes == int(((v[1:] >> shift) != (v[:-1] >> shift)).sum()) + 2
    assert rounds <= changes


def test_directory_model_several_rounds_a_tile():
    """Keys whose first 4 symbols change every few rows (2^8 buckets over
    6 symbols' prefixes): tiles of more than 31 change rows take several
    rounds, the result still the plain directory."""
    key = _model_keys(20, 5000, "dollar_n", None)
    bits = mj.mj_directory_bits(5000, 20)
    table, wrong, written, changes, rounds = _directory_model(key, 20, bits)
    tiles = -(-5001 // (32 * KDIR_ROWS))
    assert not wrong and rounds > tiles and changes > 31 * tiles // 2
    assert set(written.values()) == {1}
    assert table == mj.mj_directory_plain(torch.from_numpy(key), 20,
                                          bits).table.tolist()


@pytest.mark.parametrize("at", [1, 127, 128, 129, 1024, 2999])
def test_directory_model_flags_bad_keys(at):
    """A key below its predecessor (at a thread, warp or block edge, or
    inside a thread's rows) and a key past k symbols are flagged, as the
    plain version raises for them."""
    key = _model_keys(20, 3000, "acgt", None)
    bits = mj.mj_directory_bits(3000, 20)
    bad = key.copy()
    bad[at - 1], bad[at] = key[at] + 2, key[at - 1]
    assert _directory_model(bad, 20, bits)[1]
    with pytest.raises(ValueError, match="below its predecessor"):
        mj.mj_directory_plain(torch.from_numpy(bad), 20, bits)
    past = key.copy()
    past[at] = ((1 << 60) + at) << 1
    past[at + 1:] = np.maximum(past[at + 1:], past[at])
    assert _directory_model(past, 20, bits)[1]
    with pytest.raises(ValueError, match="outside k symbols"):
        mj.mj_directory_plain(torch.from_numpy(past), 20, bits)


# the flag, deferred to the engine's read

class _DirLib:
    """The directory's entry point faked: it sets the flag to ``bad``."""

    def __init__(self, bad: int):
        self.bad = bad
        self.calls = 0

    def asgart_mj_directory(self, skey, W, k, bits, dir_, flag, stream):
        self.calls += 1
        ctypes.c_int32.from_address(flag).value = self.bad
        return 0


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


def _no_host_read(*a, **kw):
    raise AssertionError("mj_directory read a tensor back")


@pytest.mark.parametrize("bad", [0, 1])
def test_mj_directory_makes_no_host_read(monkeypatch, bad):
    """The wrapper launches and returns: no ``item``, ``tolist``,
    ``bool`` or ``int`` of a tensor; the directory carries the kernel's
    flag, which ``check`` and the totals' read (:func:`read_totals`) raise
    on when it is set."""
    key = torch.from_numpy(_keys(np.random.default_rng(2), 20, 5000,
                                 (1, 2, 3, 5)))
    lib = _DirLib(bad)
    with monkeypatch.context() as m:
        _fake(m, lib)
        for name in ("item", "tolist", "__bool__", "__int__", "numpy"):
            m.setattr(torch.Tensor, name, _no_host_read)
        before = mj.mj_directory.launches
        d = mj.mj_directory(key, 20)
        assert mj.mj_directory.launches == before + 1 and lib.calls == 1
    assert d.flag.dtype == torch.int32 and d.flag.tolist() == [bad]
    totals = torch.tensor([5, 0, 7])
    both = mj.totals_with_flag(totals, d)
    assert both.tolist() == [5, 0, 7, bad]
    if bad:
        with pytest.raises(ValueError, match="below its predecessor"):
            d.check()
        with pytest.raises(ValueError, match="below its predecessor"):
            mj.read_totals(both)
    else:
        assert d.check() is d
        assert mj.read_totals(both) == [5, 0, 7]
    assert mj.read_totals(mj.totals_with_flag(totals, None)) == [5, 0, 7]


def _engines(tmp_path, flag):
    """The three engines that build a directory, each on the same trim
    window on the CPU with its index's directory replaced by the plain one
    carrying ``flag`` (None: no directory)."""
    from asgart_tpu_torch.device_engine import (DeviceWindowEngine,
                                                MeshWindowEngine,
                                                ShardedWindowEngine)
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.window_index import (DeviceWindowIndex,
                                               ShardedWindowIndex)

    _, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    trim = (1000, 30000)
    s = RunSettings(probe_size=20, reverse=True, complement=True)
    idx = DeviceWindowIndex.build(strand.data, 20, trim, True, True, CPU)
    sh = ShardedWindowIndex.build(strand.data, 20, trim, True, True, CPU, 0,
                                  1, False)
    mesh = MeshWindowEngine(strand, s, CPU, [trim], r=0, D=1)
    mesh.index = DeviceWindowIndex.build(strand.data, 20, trim, True, True,
                                         CPU)
    engines = [DeviceWindowEngine(strand, s, CPU, trim, cache=None,
                                  index=idx),
               ShardedWindowEngine(strand, s, CPU, trim, cache=None,
                                   index=sh), mesh]
    for eng in engines:
        ix = eng.index
        if flag is not None:
            bits = mj.mj_directory_bits(ix.key.numel(), 20)
            ix.directory = mj.mj_directory_plain(ix.key, 20, bits)._replace(
                flag=torch.tensor([flag], dtype=torch.int32))
    return engines, chunks


def test_engines_raise_on_flagged_directory(tmp_path):
    """Keys flagged by the directory kernel raise ``ValueError`` at the
    read of the join's totals on every engine that builds a directory,
    before any stage 1 is kept; a clean flag gives the stage 1 of the run
    without a directory."""
    engines, chunks = _engines(tmp_path, 1)
    for eng in engines:
        with pytest.raises(ValueError, match="below its predecessor"):
            eng.stage1(chunks)
        assert eng.index.stage1 is None
    clean, _ = _engines(tmp_path, 0)
    bare, _ = _engines(tmp_path, None)
    for a, b in zip(clean, bare):
        assert b.index.directory is None
        ra, rb = a.stage1(chunks), b.stage1(chunks)
        assert ra.offs == rb.offs and ra.specs == rb.specs
        for x, y in ((ra.lane_lo, rb.lane_lo), (ra.lane_hi, rb.lane_hi),
                     (ra.lane_mask, rb.lane_mask)):
            assert torch.equal(x, y)
