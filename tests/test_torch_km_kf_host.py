"""The designs of KM ``table_ranges`` (over the decimated position planes,
with KJ ``invert_tables`` writing them) and KF ``tie_refine`` (which
compacts the still-tied entries itself) on the CPU:

- a numpy model of KM's kernel (csrc/tables.cu) warp by warp: its chunk
  table (each chunk's first lane, the decimated index of its probe j = 0
  and its live lanes, :func:`km_table`), lane 0 of a warp finding the
  warp's first chunk once and each thread walking on from it over its 4
  lanes, both planes loaded, then masked, and the totals reduced over the
  warp where it lies in one chunk, else one lane at a time; held exactly
  to ``table_ranges_plain`` at warp, block and chunk edges: empty chunks,
  one-lane chunks, more than 256 chunks, the lane bound j * step < cl - k
  - step, N-flagged lanes and probes past n;
- the decimated address map (position x at (x % step) * C + x // step, C
  = ceil(n / step)) at every n % step, ``invert_tables_plain`` against it
  and the JAX layout carried across by ``convert.relaid_decimated``, and a
  numpy model of KJ's fill (csrc/invert.cu) writing each 2^13-position
  tile residue by residue, the last tile zeroing the slots past n, at the
  tiles' edges: every slot written once;
- a numpy model of KF's kernel (csrc/ties.cu): tiles of 256 entries, one
  a thread, the still-tied entries ranked by warp ballots and a scan of
  the tile's 8 warp counts, the tile's
  offset from a decoupled look-back over the tiles before it in windows of
  32 with the tiles publishing in any order; held exactly to
  ``tie_refine_plain``: no entry still tied, every entry still tied, a
  sub-run across a tile's edge, n = 1;
- the launches with the library faked: KM's table in the launch up to 256
  chunks and on the card past it, one launch a call, none without a lane,
  no host read or synchronize; KJ's step; KF one launch a call, none at
  n = 0; ``ties.resolve_ties`` on the faked KE and KF makes one host read
  a round and runs no cumsum, where, stack or scatter_.

The kernels themselves are held to their plain versions on the GPU
(tests/test_torch_cuda.py). Exact (integers)."""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from asgart_tpu_torch.convert import relaid_decimated
from asgart_tpu_torch.kernels import _build

from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

tables = importlib.import_module("asgart_tpu_torch.kernels.tables")
ties_k = importlib.import_module("asgart_tpu_torch.kernels.ties")
ties_mod = importlib.import_module("asgart_tpu_torch.ties")

THREADS = 256       # asgart::kThreads
GRID_CAP = 132 * 32  # asgart::grid_for's cap
KM_LANES = 4        # csrc/tables.cu kLanes
KJ_TILE = 1 << 13   # csrc/invert.cu kTile
KF_TILE = 256       # csrc/ties.cu kRefTile


def grid_for(n, cap=GRID_CAP):
    return max(1, min(-(-n // THREADS), cap))


# --- KM: a numpy model of csrc/tables.cu ----------------------------------

def model_table_ranges(pos_lo, pos_hi, table, n_chunks, total,
                       cap=GRID_CAP):
    """(lane_lo, lane_hi, lane_mask, totals, chunk searches) as KM's kernel
    computes them from its chunk table (``km_table``'s ints) and the
    decimated planes (numpy int32)."""
    off = np.array(table[:n_chunks + 1], np.int64)
    base = np.array(table[n_chunks + 1:2 * n_chunks + 1], np.int64)
    live = np.array(table[2 * n_chunks + 1:], np.int64)
    lo_out = np.full(total, -7, np.int64)
    hi_out = np.full(total, -7, np.int64)
    m_out = np.zeros(total, bool)
    totals = np.zeros(n_chunks, np.int64)
    searches = 0
    blocks = grid_for(-(-total // KM_LANES), cap)
    stride = blocks * THREADS * KM_LANES
    for warp0 in range(0, blocks * THREADS, 32):
        for w0 in range(warp0 * KM_LANES, total, stride):
            # lane 0's binary search for the warp's first lane
            c0 = int(np.searchsorted(off[1:n_chunks], w0, side="right"))
            searches += 1
            ch = np.full((32, KM_LANES), -1)
            vals = np.zeros((32, KM_LANES, 2), np.int64)
            for t in range(32):
                c = c0
                for i in range(KM_LANES):
                    lane = w0 + t * KM_LANES + i
                    if lane >= total:
                        continue
                    while c + 1 < n_chunks and off[c + 1] <= lane:
                        c += 1
                    j = lane - off[c]
                    ch[t, i] = c
                    # both loads, then the masks
                    if j < live[c]:
                        raw, hi = pos_lo[base[c] + j], pos_hi[base[c] + j]
                    else:
                        raw, hi = -1, 0
                    m = raw >= 0
                    lo, hi = (raw & 0x7FFFFFFF, hi) if m else (0, 0)
                    vals[t, i] = lo, hi
                    lo_out[lane], hi_out[lane], m_out[lane] = lo, hi, m
            v = vals[..., 1] - vals[..., 0]
            if ((ch < 0) | (ch == c0)).all():  # one chunk: warp reduction
                totals[c0] += v.sum()
            else:
                for t in range(32):
                    for i in range(KM_LANES):
                        if ch[t, i] >= 0:
                            totals[ch[t, i]] += v[t, i]
    return lo_out, hi_out, m_out, totals, searches


def _km_planes(rng, n, step, n_share=0.1):
    C, size = tables.decimated_size(n, step)
    lo = rng.integers(0, 1 << 30, size)
    hi = lo + rng.integers(0, 500, size)
    lo = np.where(rng.random(size) < n_share, lo | (1 << 31), lo)
    return (torch.from_numpy(lo.astype(np.uint32).view(np.int32)),
            torch.from_numpy(hi.astype(np.int32)))


def _km_specs(rng, n, k, n_chunks, kinds=(2, 3, 4, 0, 1)):
    """Chunks of a direct-only run (x0 = start + step): per ``kinds`` in
    turn 0 an empty chunk, 1 one lane, 2 its lanes to the lane bound, 3
    past it, 4 near the text's end (probes past n)."""
    step = k // 2
    specs = []
    for c in range(n_chunks):
        kind = kinds[c % len(kinds)]
        cl = int(rng.integers(k + step + 1, 4000))
        cs = int(rng.integers(max(0, n - cl // 2), n)) if kind == 4 else \
            int(rng.integers(0, max(1, n - cl)))
        bound = -(-(cl - k - step) // step)
        nc = (0, 1, bound, bound + int(rng.integers(1, 50)),
              bound + 3)[kind]
        specs.append((cs, cl, nc))
    return specs


def _hold_km(rng, n, k, n_chunks, cap=GRID_CAP, **kw):
    step = k // 2
    lo, hi = _km_planes(rng, n, step)
    specs = _km_specs(rng, n, k, n_chunks, **kw)
    lane_off, x0s, cls = tables.table_x0s(specs, n, k, False, False)
    want = tables.table_ranges_plain(lo, hi, lane_off, x0s, cls, k, n)
    table = tables.km_table(lane_off, x0s, cls, k, n)
    got = model_table_ranges(lo.numpy().astype(np.int64),
                             hi.numpy().astype(np.int64), table,
                             len(specs), lane_off[-1], cap)
    for g, w in zip(got[:4], want):
        assert np.array_equal(g, w.numpy().astype(g.dtype))
    # the lane bound and x < n fold into live: brute force
    for c, (x0, cl) in enumerate(zip(x0s, cls)):
        nc = lane_off[c + 1] - lane_off[c]
        j = np.arange(nc)
        ok = (j * step < cl - k - step) & (x0 + j * step < n)
        assert table[2 * len(specs) + 1 + c] == int(ok.sum())
        assert not ok[int(ok.sum()):].any()
    return got, want


@pytest.mark.parametrize("k", [4, 20, 25, 30])
@pytest.mark.parametrize("n_chunks", [1, 5, 33, 257])
def test_km_model_chunk_edges(k, n_chunks):
    """Chunks of every kind, more than 256 of them (the table on the card:
    the same kernel body), N flags and probes past n."""
    rng = np.random.default_rng(k * 1000 + n_chunks)
    got, want = _hold_km(rng, 40_000 + n_chunks % (k // 2), k, n_chunks)
    assert want[2].any() and (~want[2]).any()


@pytest.mark.parametrize("cap", [1, 3, GRID_CAP])
def test_km_model_grid_stride_and_warp_edges(cap):
    """One-lane and empty chunks at the warps' 128-lane and the blocks'
    1024-lane edges, through a grid of 1 and 3 blocks (every warp loops)
    and the full grid; a warp inside one chunk searches once."""
    rng = np.random.default_rng(cap)
    got, _ = _hold_km(rng, 60_000, 20, 64, cap=cap,
                      kinds=(2, 1, 0, 1, 3, 0, 0, 1))
    assert got[4] == -(-len(got[0]) // (32 * KM_LANES))


def test_km_model_one_lane_and_all_n():
    rng = np.random.default_rng(3)
    _hold_km(rng, 100, 20, 1, kinds=(1,))
    step = 10
    lo, hi = _km_planes(rng, 5_000, step, n_share=1.0)
    specs = _km_specs(rng, 5_000, 20, 4, kinds=(2,))
    got = tables.table_ranges(lo, hi, specs, 5_000, 20, False, False)
    assert not got[2].any() and not got[3].any()


@pytest.mark.parametrize("n_chunks", [1, 256, 257])
def test_km_table_ints(n_chunks):
    """km_table: offsets, then bases and live counts, every value in int32
    (the base as uint32 bits), and base 0 for a chunk with no live lane."""
    rng = np.random.default_rng(n_chunks)
    n, k = 100_003, 25
    specs = _km_specs(rng, n, k, n_chunks)
    lane_off, x0s, cls = tables.table_x0s(specs, n, k, False, False)
    t = tables.km_table(lane_off, x0s, cls, k, n)
    assert len(t) == 3 * n_chunks + 1 and t[:n_chunks + 1] == lane_off
    C = -(-n // 12)
    for c, x0 in enumerate(x0s):
        live = t[2 * n_chunks + 1 + c]
        base = t[n_chunks + 1 + c]
        assert base == ((x0 % 12) * C + x0 // 12 if live else 0)
        assert 0 <= live <= lane_off[c + 1] - lane_off[c]
        assert 0 <= base < 1 << 32


# --- the decimated layout and KJ's residue-major flush --------------------

@pytest.mark.parametrize("step", [1, 2, 10, 12, 15])
def test_decimated_map_at_every_residue(step):
    """Position x at (x % step) * C + x // step, C = ceil(n / step): a
    bijection of [0, n) into [0, step * C) at every n % step; the plain
    KJ writes there, zeroes the rest, and a chunk's probes x0 + j * step
    are one contiguous run; the JAX layout (longer rows, zero-padded)
    re-laid there agrees."""
    rng = np.random.default_rng(step)
    for n in range(5 * step + 1, 6 * step + 1):
        C, size = tables.decimated_size(n, step)
        x = np.arange(n)
        dec = (x % step) * C + x // step
        assert len(set(dec.tolist())) == n and dec.max() < size
        sa = torch.from_numpy(rng.permutation(n).astype(np.int32))
        lo = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                              .astype(np.int32))
        pos_lo, pos_hi, rank = tables.invert_tables_plain(sa, lo, lo, step)
        want = np.zeros(size, np.int32)
        want[dec[sa.numpy()]] = lo.numpy()
        assert np.array_equal(pos_lo.numpy(), want)
        assert np.array_equal(rank.numpy()[sa.numpy()],
                              lo.numpy() & 0x7FFFFFFF)
        x0 = int(rng.integers(0, n))
        run = np.arange(x0, n, step)
        assert np.array_equal(np.diff(dec[run]), np.ones(len(run) - 1))
        # the JAX layout: rows of C + 3 columns, zero past the text
        L = step * (C + 3)
        jax_tab = np.zeros(L, np.int32)
        jax_tab[(x % step) * (C + 3) + x // step] = want[dec]
        assert np.array_equal(relaid_decimated(jax_tab, step, n), want)


def model_fill_flush(M, step, tile=KJ_TILE):
    """The slots KJ's fill writes (csrc/invert.cu, the decimated table
    form), each with the position it writes: per tile [start, start + n)
    residue by residue, runs of the positions with that residue; the last
    tile's zeros at each residue's slot past M (position -1)."""
    C, size = tables.decimated_size(M, step)
    writes = np.zeros(size, np.int64)
    what = np.full(size, -2, np.int64)
    for start in range(0, M, tile):
        n = min(tile, M - start)
        s0 = start % step
        for r in range(step):
            q0 = (r - s0 + step) % step
            if q0 >= n:
                continue
            cnt = (n - 1 - q0) // step + 1
            out0 = r * C + (start + q0) // step
            for m in range(cnt):
                writes[out0 + m] += 1
                what[out0 + m] = start + q0 + m * step
        if start + n == M:
            for t in range(step):
                if t + (C - 1) * step >= M:
                    writes[t * C + C - 1] += 1
                    what[t * C + C - 1] = -1
    return writes, what, C


@pytest.mark.parametrize("step", [1, 7, 10, 12, 15])
@pytest.mark.parametrize("M", [1, 9, KJ_TILE - 1, KJ_TILE, KJ_TILE + 1,
                               3 * KJ_TILE + 5])
def test_kj_flush_model(M, step):
    writes, what, C = model_fill_flush(M, step)
    assert (writes == 1).all()  # every slot written once
    x = np.arange(M)
    assert np.array_equal(what[(x % step) * C + x // step], x)
    assert ((what == -1).sum()) == step * C - M


# --- KF: a numpy model of csrc/ties.cu ------------------------------------

def model_tie_refine(skey, order, slots, ps, sa, rank, rng):
    """(outputs, count) as KF's kernel writes them, sa and rank updated in
    place: each tile's entries, one a thread, their ballot ranks and the
    scan of the warps' counts, and its offset from a look-back over tiles
    that publish in the order ``rng`` draws (every tile's aggregate is out,
    then the tiles take their look-back in a random order, each publishing
    its inclusive prefix)."""
    n = len(skey)
    n_tiles = -(-n // KF_TILE)
    out = np.zeros((3, n), np.int64)
    # each entry's sub-run start (the kernel gallops back to it)
    idx = np.arange(n)
    new_run = np.ones(n, bool)
    new_run[1:] = skey[1:] != skey[:-1]
    run_start = np.maximum.accumulate(np.where(new_run, idx, 0))
    per_tile = []
    for tile in range(n_tiles):
        counts = np.zeros(KF_TILE // 32, np.int64)
        entries = []
        for w in range(KF_TILE // 32):
            ballot = []
            for ln in range(32):
                r = tile * KF_TILE + w * 32 + ln
                if r >= n:
                    ballot.append(False)
                    continue
                s = run_start[r]
                p = ps[order[r]]
                rs = slots[s]
                sa[slots[r]] = p
                rank[p] = rs
                still = s < r or (r + 1 < n and skey[r + 1] == skey[r])
                ballot.append(still)
                if still:
                    entries.append((w, sum(ballot[:-1]), (slots[r], p, rs)))
            counts[w] = sum(ballot)
        excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
        per_tile.append((excl, entries, counts.sum()))
    status = [("agg", t[2]) for t in per_tile]
    for tile in rng.permutation(n_tiles):
        base, look = 0, tile - 1
        while look >= 0:  # windows of 32 tiles, nearest first
            window = [status[t] for t in range(look, max(look - 32, -1), -1)]
            first = next((i for i, st in enumerate(window)
                          if st[0] == "inc"), None)
            part = window if first is None else window[:first + 1]
            base += sum(st[1] for st in part)
            if first is not None:
                break
            look -= 32
        excl, entries, agg = per_tile[tile]
        status[tile] = ("inc", base + agg)
        for w, rk, vals in entries:
            out[:, base + excl[w] + rk] = vals
    return out, status[-1][1] if n_tiles else 0


def _tie_round(rng, n, ties):
    if ties == "none":
        skey = np.arange(n, dtype=np.int64)
    elif ties == "all":
        skey = np.zeros(n, dtype=np.int64)
    elif ties == "edge":  # pairs, one across every tile edge
        skey = (np.arange(n) + 1) // 2
    else:
        skey = np.repeat(np.arange(n), rng.integers(1, 30, n))[:n]
    slots = np.sort(rng.choice(4 * n, n, replace=False)).astype(np.int32)
    ps = rng.choice(2 * n + 1, n, replace=False).astype(np.int32)
    order = rng.permutation(n).astype(np.int64)
    sa = rng.integers(0, 2 * n + 1, 4 * n).astype(np.int32)
    rank = rng.integers(0, 4 * n, 2 * n + 1).astype(np.int32)
    return skey, order, slots, ps, sa, rank


@pytest.mark.parametrize("ties", ["none", "all", "edge", "runs"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 3 * 256 + 1,
                               40 * 256 + 3])
def test_kf_model_compaction(n, ties):
    """KF's model against ``tie_refine_plain``: sa, rank, the count and the
    compacted entries, in slot order, at every tile edge and past a
    look-back window (32 tiles)."""
    rng = np.random.default_rng(n + len(ties))
    arrays = _tie_round(rng, n, ties)
    t = [torch.from_numpy(a.copy()) for a in arrays]
    cnt = torch.full((1,), -1, dtype=torch.int32)
    want = ties_k.tie_refine_plain(*t, cnt)
    m = int(cnt)
    sa, rank = arrays[4].copy(), arrays[5].copy()
    got, count = model_tie_refine(*arrays[:4], sa, rank, rng)
    assert count == m
    assert np.array_equal(sa, t[4].numpy())
    assert np.array_equal(rank, t[5].numpy())
    for g, w in zip(got, want):
        assert np.array_equal(g[:m], w.numpy()[:m])
    assert (np.diff(got[0][:m]) > 0).all()  # slots ascend
    expect = {"none": 0, "all": n if n > 1 else 0,
              "edge": n - 2 if n % 2 == 0 else n - 1 if n > 1 else 0}
    assert m == expect.get(ties, m)


# --- the launches, with the library faked ---------------------------------

def _ints(ptr, n, ctype=ctypes.c_int32):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class _Lib:
    """KM, KJ, KE and KF entry points over CPU memory: each records its
    call; KE and KF compute their results with the plain versions, KF's
    through its kernel's model."""

    def __init__(self):
        self.calls = []

    def asgart_table_ranges(self, *a):
        (pos_lo, pos_hi, table, n_chunks, cap, total, lane_lo, lane_hi,
         lane_mask, totals, stream) = a
        ints = _ints(table, 3 * n_chunks + 1).tolist()
        self.calls.append(("KM", dict(cap=cap, n_chunks=n_chunks,
                                      total=total, table=ints)))
        return 0

    def asgart_invert_tables(self, *a):
        self.calls.append(("KJ", dict(n=a[3], step=a[16])))
        return 0

    def asgart_tie_keys(self, ps, prims, rank, n, W, h, key, bad, stream):
        t = [torch.from_numpy(_ints(p, m)) for p, m in
             ((ps, n), (prims, n), (rank, W))]
        b = torch.from_numpy(_ints(bad, 1))
        k = torch.from_numpy(_ints(key, n, ctypes.c_int64))
        k.copy_(ties_k.tie_keys_plain(*t, h, b))
        self.calls.append(("KE", dict(n=n)))
        return 0

    def asgart_tie_refine(self, skey, order, slots, ps, n, sa, rank,
                          o_slots, o_ps, o_prims, count, scratch, n_tiles,
                          stream):
        assert n_tiles == -(-n // KF_TILE) == -(-n // ties_k.TIE_TILE)
        i64 = ctypes.c_int64
        arrays = [_ints(skey, n, i64), _ints(order, n, i64),
                  _ints(slots, n), _ints(ps, n)]
        sa_a = _ints(sa, self.sa_n)
        rank_a = _ints(rank, self.rank_n)
        out, m = model_tie_refine(*arrays, sa_a, rank_a,
                                  np.random.default_rng(n))
        for p, row in zip((o_slots, o_ps, o_prims), out):
            _ints(p, n)[:m] = row[:m]
        _ints(count, 1)[0] = m
        self.calls.append(("KF", dict(n=n)))
        return 0


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


def _no_wait(monkeypatch):
    """Any host read or synchronize raises."""
    def refused(*a, **kw):
        raise AssertionError("the call waits for the card")

    for name in ("tolist", "item", "cpu", "numpy", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)


@pytest.mark.parametrize("n_chunks", [0, 1, 256, 257])
def test_table_ranges_launch(monkeypatch, n_chunks):
    """KM's chunk table in the launch up to 256 chunks (a host pointer,
    cap 256), past it on the card from pinned memory (cap 0); one launch a
    call, none without a lane (zero totals); no host read."""
    rng = np.random.default_rng(n_chunks)
    n, k = 30_001, 20
    lo, hi = _km_planes(rng, n, 10)
    specs = _km_specs(rng, n, k, n_chunks) if n_chunks else []
    lib = _Lib()
    _fake(monkeypatch, lib)
    pinned = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t: pinned.append(t.numel()) or t)
    before = tables.table_ranges.launches
    with monkeypatch.context() as mp:
        _no_wait(mp)
        got = tables.table_ranges(lo, hi, specs, n, k, False, False)
    total = sum(nc for *_, nc in specs)
    assert tables.table_ranges.launches == before + (total > 0)
    assert got[3].shape == (n_chunks,) and got[4][-1] == total
    if total == 0:
        assert not lib.calls and not got[3].any()
        return
    ((name, c),) = lib.calls
    lane_off, x0s, cls = tables.table_x0s(specs, n, k, False, False)
    want = tables.km_table(lane_off, x0s, cls, k, n)
    assert c["table"] == [v - (1 << 32) if v >= 1 << 31 else v
                          for v in want]
    assert c["cap"] == (256 if n_chunks <= 256 else 0)
    assert pinned == ([] if n_chunks <= 256 else [3 * n_chunks + 1])


def test_table_ranges_refuses_plain_planes():
    """The planes must have the decimated layout's size."""
    n, k = 1001, 20
    plain = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="decimated"):
        tables.table_ranges(plain, plain, [(0, 500, 10)], n, k, False, False)


@pytest.mark.parametrize("step", [1, 10])
def test_invert_tables_step_launch(monkeypatch, step):
    """KJ gets its step; the planes have step * C entries, rank n."""
    lib = _Lib()
    _fake(monkeypatch, lib)
    n = 8193
    sa = torch.arange(n, dtype=torch.int32)
    pos_lo, pos_hi, rank = tables.invert_tables(sa, sa.clone(), sa.clone(),
                                                step)
    assert lib.calls == [("KJ", dict(n=n, step=step))]
    assert pos_lo.numel() == pos_hi.numel() == step * -(-n // step)
    assert rank.numel() == n


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_tie_refine_launch(monkeypatch, n):
    """One KF launch a call (its count written on the device), none for no
    entry (a count of 0)."""
    rng = np.random.default_rng(n)
    arrays = _tie_round(rng, max(n, 1), "runs")
    t = [torch.from_numpy(a.copy()) for a in arrays]
    if n == 0:
        t[:4] = [x[:0] for x in t[:4]]
    lib = _Lib()
    lib.sa_n, lib.rank_n = t[4].numel(), t[5].numel()
    _fake(monkeypatch, lib)
    cnt = torch.full((1,), -1, dtype=torch.int32)
    before = ties_k.tie_refine.launches
    got = ties_k.tie_refine(*t, cnt)
    assert ties_k.tie_refine.launches == before + (n > 0)
    assert [c for c, _ in lib.calls] == (["KF"] if n else [])
    assert all(g.shape == (n,) for g in got)
    if n == 0:
        assert int(cnt) == 0
        return
    cp = torch.zeros(1, dtype=torch.int32)
    want = ties_k.tie_refine_plain(*(torch.from_numpy(a.copy())
                                     for a in arrays), cp)
    m = int(cp)
    assert int(cnt) == m
    for g, w in zip(got, want):
        assert torch.equal(g[:m], w[:m])


def test_resolve_ties_one_read_a_round(monkeypatch):
    """``resolve_ties`` on the faked KE and KF: the round's only host read
    is one ``tolist`` of KE's flag and KF's count, no cumsum, where, stack
    or scatter_ runs in a round, and the order is the plain rounds'."""
    rng = np.random.default_rng(5)
    W, M, k = 1500, 2000, 4
    text = rng.integers(0, 2, W - 1)  # a binary text: deep ties
    # suffix order of text + '$' by brute force, its 4-mer groups tied
    suf = sorted(range(W), key=lambda p: (list(text[p:]) + [-1]))
    sa = torch.tensor(suf + list(range(W, M)), dtype=torch.int32)
    key = [tuple(text[p:p + k]) if p + k <= W - 1 else None for p in suf]
    rank = torch.zeros(W, dtype=torch.int32)
    tied = torch.zeros(M, dtype=torch.bool)
    start = 0
    for s in range(1, W + 1):
        if s == W or key[s] is None or key[s] != key[start]:
            if s - start > 1 and key[start] is not None:
                tied[start:s] = True
            for q in range(start, s):
                rank[suf[q]] = start
            start = s
    assert int(tied.sum()) > 1000
    # the plain rounds on the CPU give the reference order
    want = ties_mod.resolve_ties(sa.clone(), rank.clone(), tied, M, k)
    lib = _Lib()
    lib.sa_n, lib.rank_n = M, W
    _fake(monkeypatch, lib)
    reads = []
    real = torch.Tensor.tolist

    def refused(*a, **kw):
        raise AssertionError("a tie round ran a compaction op")

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "tolist",
                   lambda t: reads.append(t.numel()) or real(t))
        for name in ("cumsum", "where", "stack"):
            mp.setattr(torch, name, refused)
        mp.setattr(torch.Tensor, "scatter_", refused)
        got = ties_mod.resolve_ties(sa.clone(), rank.clone(), tied, M, k)
    rounds = [c for c, _ in lib.calls]
    assert rounds == ["KE", "KF"] * (len(rounds) // 2) and len(rounds) > 2
    assert reads == [2] * (len(rounds) // 2)
    assert torch.equal(got, want)
