"""The designs of KE ``tie_keys`` (which sorts each tied group of its round
itself) and KO ``granule_totals`` (a warp a granule, 16-byte vectors) on
the CPU:

- a numpy model of KE's sort (csrc/ties.cu, tests/ke_ko_model.py): tiles
  of 256 entries a block and 32 a warp, windows of 32 lanes from a group
  start sorted by (group start lane, sec, lane) with g odd-even
  transposition steps or the bitonic network, groups of 33 to 128
  entries (the capacity) by the warp in registers (the bitonic network
  over 64 or 128 keys); held exactly to ``tie_keys_plain`` (the keys and
  the library's stable sort) at groups of 2, 32, 33, 64, 65 and 128,
  groups that fill a tile's width, groups across tiles' edges, the whole
  set in one group, equal sec inside groups (stability), n = 2 and the
  ``bad`` flag; a group one past the capacity, or of a tile's width,
  written unsorted and in range with 2 ORed into ``bad``;
- a numpy model of KO's kernel (csrc/slices.cu) held exactly to
  ``granule_totals_plain`` on views at every lane offset from a 16-byte
  boundary, arrays whose offsets differ (the scalar path), a partial last
  granule, granules with every lane masked and with none, and totals
  past 2^31;
- the launches with the library faked: KE's route (its sort up to
  ``TIE_SORT_CAP``, the key pass and ``torch.sort`` past it or where the
  largest group is not known); KE's sizing pass ``tie_groups``;
  ``ties.resolve_ties`` making one host read a round, of three words, and
  one before its loop (the sizing pass's figure) only where the tied set
  reaches ``ties.SIZING_MIN``, and taking the library route where the
  round's largest group (the sizing pass's, then KF's longest still-tied
  sub-run of the round before) passes the capacity or is not known, and
  nowhere else; KO one launch a call.

The kernels themselves are held to their plain versions on the GPU
(tests/test_torch_cuda.py). Exact (integers)."""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from asgart_tpu_torch.kernels import _build

from ke_ko_model import (OETS, SortRecord, model_granule_totals,
                         model_tie_sort)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

ties_k = importlib.import_module("asgart_tpu_torch.kernels.ties")
ties_mod = importlib.import_module("asgart_tpu_torch.ties")
slices = importlib.import_module("asgart_tpu_torch.kernels.slices")

CAP = ties_k.TIE_SORT_CAP


# --- KE: the sort's model against the plain version ------------------------

def _round(rng, sizes, W=None, equal_secs=False):
    """(ps, prims, rank, h) of a round whose groups have ``sizes``: prims
    the groups' start slots (ascending), distinct positions, a rank plane
    with few distinct values where ``equal_secs``."""
    n = int(sum(sizes))
    W = W or 4 * n + 64
    starts = np.repeat(np.cumsum([0] + list(sizes[:-1])), sizes)
    prims = (3 * starts + 1).astype(np.int32)
    ps = rng.choice(W - 40, n, replace=False).astype(np.int32)
    hi = 3 if equal_secs else W
    rank = rng.integers(0, hi, W).astype(np.int32)
    return ps, prims, rank, 17


def _plain(ps, prims, rank, h):
    bad = torch.zeros(1, dtype=torch.int32)
    skey, order = ties_k.tie_keys_plain(
        *(torch.from_numpy(a.copy()) for a in (ps, prims, rank)), h, bad)
    return skey.numpy(), order.numpy(), int(bad)


def _held(ps, prims, rank, h):
    rec = SortRecord()
    skey, order, bad = model_tie_sort(ps, prims, rank, h, rec)
    want = _plain(ps, prims, rank, h)
    assert np.array_equal(skey, want[0])
    assert np.array_equal(order, want[1])
    assert int(bad[0]) == want[2]
    return rec


CASES = {
    "pairs": [2] * 3000,
    "thirty_two": [32] * 100,
    "thirty_three": [33] * 80,
    "registers": [64, 65, 2, 128, 3] * 20,
    "tile": [CAP] * 6,  # two groups a tile, at the capacity
    "across_a_tile": [2] * 500 + [40] + [2] * 20 + [100] + [5] * 300
    + [3] * 100 + [120] + [2] * 10 + [CAP] + [2] * 5,
    "one_group": [CAP],
    "mixed": None,
    "n2": [2],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ke_model_groups(case):
    rng = np.random.default_rng(len(case))
    sizes = CASES[case]
    if sizes is None:  # 2..CAP, most small: every warp path
        sizes = list(np.where(rng.random(4000) < 0.9,
                              rng.integers(2, 8, 4000),
                              rng.integers(2, CAP + 1, 4000)))
    rec = _held(*_round(rng, sizes))
    assert not rec.big
    if case == "pairs":
        assert set(rec.steps) == {2}
    if case == "thirty_two":
        assert set(rec.steps) == {-1}  # one group a window
    if case == "thirty_three":
        assert set(rec.regs) == {33}
    if case == "registers":
        assert set(rec.regs) == {64, 65, 128}
    if case in ("tile", "one_group"):
        assert set(rec.regs) == {CAP}
    if case == "across_a_tile":
        assert sorted(rec.regs) == [40, 100, 120, CAP]
    if case == "mixed":
        assert -1 in rec.steps and any(0 < s < OETS for s in rec.steps)
        assert rec.regs


@pytest.mark.parametrize("sizes", [[2, 7, 40, 3, 120] * 100,
                                   [CAP, 2, 100, 90]])
def test_ke_model_equal_secs_stable(sizes):
    """Few distinct sec values: the order within a group is the entries'
    order where sec ties, in the warp windows and the register sort."""
    rng = np.random.default_rng(len(sizes))
    rec = _held(*_round(rng, sizes, equal_secs=True))
    assert rec.regs and -1 in rec.steps + [-1]


@pytest.mark.parametrize("size", [CAP + 1, 256])
def test_ke_model_past_the_capacity(size):
    """A group of the capacity sorts in registers; one past it (also one
    of a tile's width) is written unsorted, in range (each entry its own
    key, order[i] = i), and ORs 2 into bad (the route keeps such a
    round away); the groups around it are still sorted."""
    rng = np.random.default_rng(size)
    rec = _held(*_round(rng, [2, CAP, 3]))
    assert rec.regs == [CAP] and not rec.big
    ps, prims, rank, h = _round(rng, [2, size, 3])
    rec = SortRecord()
    skey, order, bad = model_tie_sort(ps, prims, rank, h, rec)
    assert rec.big == [size] and int(bad[0]) == 2
    big = slice(2, 2 + size)
    assert np.array_equal(order[big], np.arange(2, 2 + size))
    key = (prims.astype(np.int64) << 32) | (rank[ps + h].astype(np.int64)
                                            + 1)
    assert np.array_equal(skey[big], key[big])
    want = _plain(ps, prims, rank, h)
    for got, w in zip((skey, order), want[:2]):
        assert np.array_equal(got[:2], w[:2])
        assert np.array_equal(got[2 + size:], w[2 + size:])


def test_ke_model_bad_flag():
    """A read past the direct text ORs 1 into bad and reads rank[W -
    1], in a window and in the register sort."""
    rng = np.random.default_rng(3)
    for sizes in ([2, 3, 2], [2, 50]):
        ps, prims, rank, h = _round(rng, sizes)
        ps[-1] = len(rank) - 5
        _, _, bad = model_tie_sort(ps, prims, rank, h)
        assert int(bad[0]) == 1
        _held(ps, prims, rank, h)


def test_ke_model_refuses_a_group_of_one():
    rng = np.random.default_rng(4)
    ps, prims, rank, h = _round(rng, [2, 2])
    prims[-1] += 1
    with pytest.raises(AssertionError, match="group of one"):
        model_tie_sort(ps, prims, rank, h)


# --- KO: the kernel's model against the plain version ------------------------

def _lanes(rng, n, kind):
    lo = rng.integers(0, 1 << 20, n).astype(np.int32)
    hi = (lo + rng.integers(0, 1 << 10, n)).astype(np.int32)
    mask = rng.random(n) < 0.7
    if kind == "all_masked":
        mask[:] = False
    elif kind == "none_masked":
        mask[:] = True
    elif kind == "wide":  # granule totals past 2^31
        lo[:] = 0
        hi[:] = (1 << 31) - 1
        mask[:] = True
    return lo, hi, mask


@pytest.mark.parametrize("kind", ["random", "all_masked", "none_masked",
                                  "wide"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("gran", [64, 4096, 61])
def test_ko_model_views(kind, offset, gran):
    """KO's model on views at lane ``offset`` of the three arrays (one skew:
    vectors between the scalar ends) with a partial last granule."""
    rng = np.random.default_rng(offset + gran)
    n = 3 * gran + 13
    base = [torch.from_numpy(a) for a in _lanes(rng, n + offset, kind)]
    lo, hi, mask = (t[offset:] for t in base)
    want = slices.granule_totals_plain(lo, hi, mask, gran).numpy()
    at = [t.data_ptr() % 16 for t in (lo, hi, mask)]
    got, scalars = model_granule_totals(lo.numpy(), hi.numpy(),
                                        mask.numpy(), gran, *at)
    assert np.array_equal(got, want)
    assert scalars <= 6 * -(-n // gran)  # at most 3 at each end
    if kind == "wide":
        assert got.max() > 2**31


@pytest.mark.parametrize("shifts", [(0, 1, 0), (1, 0, 0), (0, 0, 2),
                                    (2, 1, 3)])
def test_ko_model_differing_skews(shifts):
    """Arrays at different lane offsets from a 16-byte boundary: every lane
    a scalar, the same totals."""
    rng = np.random.default_rng(sum(shifts))
    n, gran = 5000, 64
    arrays = _lanes(rng, n + 4, "random")
    lo, hi, mask = (torch.from_numpy(a)[s:s + n]
                    for a, s in zip(arrays, shifts))
    want = slices.granule_totals_plain(lo, hi, mask, gran).numpy()
    at = [t.data_ptr() % 16 for t in (lo, hi, mask)]
    got, scalars = model_granule_totals(lo.numpy(), hi.numpy(),
                                        mask.numpy(), gran, *at)
    assert np.array_equal(got, want)
    assert scalars == n


# --- the launches, with the library faked ------------------------------------

def _ints(ptr, n, ctype=ctypes.c_int32):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class _Lib:
    """KE's two entry points (its sort through the model), KF (the plain
    version) and KO over CPU memory, each recording its call. ``strict``:
    a group past the model's capacity handed to KE's sort fails the test
    (else the model's unsorted group and flag come back)."""

    def __init__(self, sa_n=0, rank_n=0, strict=True):
        self.calls = []
        self.sa_n, self.rank_n, self.strict = sa_n, rank_n, strict

    def asgart_tie_keys(self, ps, prims, rank, n, W, h, key, bad, stream):
        t = [torch.from_numpy(_ints(p, m)) for p, m in
             ((ps, n), (prims, n), (rank, W))]
        ph = t[0].long() + h
        if (ph >= W).any():
            _ints(bad, 1)[0] = 1
        sec = t[2][ph.clamp(max=W - 1)].long()
        _ints(key, n, ctypes.c_int64)[:] = ((t[1].long() << 32)
                                            | (sec + 1)).numpy()
        self.calls.append(("KE keys", n))
        return 0

    def asgart_tie_groups(self, prims, n, largest, stream):
        t = torch.from_numpy(_ints(prims, n).copy())
        out = torch.zeros(1, dtype=torch.int32)
        ties_k.tie_groups_plain(t, out)
        _ints(largest, 1)[0] = int(out)
        self.calls.append(("KE groups", n))
        return 0

    def asgart_tie_sort(self, ps, prims, rank, n, W, h, skey, order, bad,
                        stream):
        arrays = [_ints(p, m).copy() for p, m in
                  ((ps, n), (prims, n), (rank, W))]
        rec = SortRecord()
        s, o, b = model_tie_sort(*arrays, h, rec)
        assert not (self.strict and rec.big), \
            "a group past the capacity was routed here"
        _ints(skey, n, ctypes.c_int64)[:] = s
        _ints(order, n, ctypes.c_int64)[:] = o
        _ints(bad, 1)[0] |= b[0]
        self.calls.append(("KE sort", n))
        return 0

    def asgart_tie_refine(self, skey, order, slots, ps, n, sa, rank,
                          o_slots, o_ps, o_prims, count, largest, scratch,
                          n_tiles, stream):
        i64 = ctypes.c_int64
        t = [torch.from_numpy(a) for a in (
            _ints(skey, n, i64), _ints(order, n, i64), _ints(slots, n),
            _ints(ps, n), _ints(sa, self.sa_n), _ints(rank, self.rank_n))]
        cnt = torch.zeros(2, dtype=torch.int32)
        out = ties_k.tie_refine_plain(*t, cnt)
        for p, row in zip((o_slots, o_ps, o_prims), out):
            _ints(p, n)[:] = row.numpy()
        _ints(count, 1)[0] = int(cnt[0])
        _ints(largest, 1)[0] = int(cnt[1])
        self.calls.append(("KF", n))
        return 0

    def asgart_granule_totals(self, lo, hi, mask, n, gran, totals, stream):
        m = -(-n // gran)
        got, _ = model_granule_totals(
            _ints(lo, n), _ints(hi, n),
            _ints(mask, n, ctypes.c_bool), gran, lo % 16, hi % 16,
            mask % 16)
        _ints(totals, m, ctypes.c_int64)[:] = got
        self.calls.append(("KO", n))
        return 0


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


@pytest.mark.parametrize("largest", [None, 2, CAP, CAP + 1])
def test_tie_keys_route(monkeypatch, largest):
    """KE sorts itself up to the capacity; past it, or where the largest
    group is not known, the key pass and the library's stable sort; one
    launch either way, the plain version's result."""
    rng = np.random.default_rng(7)
    sizes = [2, 5, 33] if largest in (None, 2) else [3, largest, 2]
    arrays = _round(rng, sizes)
    t = [torch.from_numpy(a.copy()) for a in arrays[:3]]
    lib = _Lib()
    _fake(monkeypatch, lib)
    before = ties_k.tie_keys.launches
    bad = torch.zeros(1, dtype=torch.int32)
    got = ties_k.tie_keys(*t, arrays[3], bad, largest)
    assert ties_k.tie_keys.launches == before + 1
    route = "KE sort" if largest is not None and largest <= CAP \
        else "KE keys"
    assert lib.calls == [(route, sum(sizes))]
    want = _plain(*arrays)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])


def _binary_ties(seed, W=1500, M=2000, k=4):
    """(sa, rank, tied, M, k) of a binary text's suffix order with its
    k-mer groups tied (deep ties: many rounds, groups past 32)."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 2, W - 1)
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
    return sa, rank, tied, M, k


@pytest.mark.parametrize("sized", [False, True])
@pytest.mark.parametrize("cap", [8, 64, CAP])
def test_resolve_ties_routes_by_kf_largest(monkeypatch, cap, sized):
    """``resolve_ties`` on the faked kernels: one host read a round, of
    KE's flag, KF's count and KF's longest still-tied sub-run (the next
    round's largest group), and, where the tied set reaches
    ``SIZING_MIN`` (``sized``: set to 0 here), KE's sizing pass and one
    host read before the loop (the first round's largest group); else the
    first round on the library route. The library route where the round's
    largest group passes the capacity or is not known, KE's sort
    everywhere else; the plain rounds' order."""
    sa, rank, tied, M, k = _binary_ties(5)
    want = ties_mod.resolve_ties(sa.clone(), rank.clone(), tied, M, k)
    lib = _Lib(M, len(rank))
    _fake(monkeypatch, lib)
    monkeypatch.setattr(ties_k, "TIE_SORT_CAP", cap)
    if sized:
        monkeypatch.setattr(ties_mod, "SIZING_MIN", 0)
    else:
        assert int(tied.sum()) < ties_mod.SIZING_MIN
    reads = []
    real = torch.Tensor.tolist
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "tolist",
                   lambda t: reads.append(real(t)) or real(t))
        got = ties_mod.resolve_ties(sa.clone(), rank.clone(), tied, M, k)
    assert torch.equal(got, want)
    calls = [c[0] for c in lib.calls]
    if sized:
        assert calls[0] == "KE groups" and len(reads[0]) == 1
        calls, first, reads = calls[1:], reads[0][0], reads[1:]
    else:
        first = None
    assert "KE groups" not in calls
    kes = calls[::2]
    assert calls[1::2] == ["KF"] * len(kes) and len(kes) > 2
    assert len(reads) == len(kes) and all(len(r) == 3 for r in reads)
    largest = [first] + [r[2] for r in reads[:-1]]
    assert kes == ["KE sort" if g is not None and g <= cap else "KE keys"
                   for g in largest]
    assert "KE sort" in kes
    if cap == 8 or not sized:  # both routes in one resolution
        assert "KE keys" in kes
    if sized:
        assert largest[0] > 8


def test_resolve_ties_raises_on_a_group_past_the_kernel(monkeypatch):
    """A route that hands KE's sort a group past what it sorts (the
    capacity patched above the kernel's) gets that group back unsorted
    and in range with 2 ORed into the flag: ``resolve_ties`` raises its
    own message after the round's one read, before a second round."""
    sa, rank, tied, M, k = _binary_ties(5, k=2)  # groups of ~375
    lib = _Lib(M, len(rank), strict=False)
    _fake(monkeypatch, lib)
    monkeypatch.setattr(ties_k, "TIE_SORT_CAP", 1 << 20)
    monkeypatch.setattr(ties_mod, "SIZING_MIN", 0)
    with pytest.raises(RuntimeError, match="longer than"):
        ties_mod.resolve_ties(sa, rank, tied, M, k)
    assert [c[0] for c in lib.calls] == ["KE groups", "KE sort", "KF"]


@pytest.mark.parametrize("sizes", [[], [2], [2, 3, 40, 2], [30000]])
def test_tie_groups_launch(monkeypatch, sizes):
    """KE's sizing pass: one launch a call (a zeroed word for no entry),
    the longest run of equal prims, as the plain version finds it."""
    rng = np.random.default_rng(len(sizes))
    prims = torch.from_numpy(_round(rng, sizes)[1] if sizes else
                             np.zeros(0, np.int32))
    lib = _Lib()
    _fake(monkeypatch, lib)
    before = ties_k.tie_groups.launches
    out = torch.full((1,), -1, dtype=torch.int32)
    ties_k.tie_groups(prims, out)
    assert ties_k.tie_groups.launches == before + 1
    assert int(out) == max(sizes, default=0)


@pytest.mark.parametrize("offset", [0, 3])
def test_granule_totals_launch(monkeypatch, offset):
    """One KO launch a call on views (none for no lane); its model's
    totals."""
    rng = np.random.default_rng(offset)
    n, gran = 1000, 64
    base = [torch.from_numpy(a) for a in _lanes(rng, n + offset, "random")]
    lo, hi, mask = (t[offset:] for t in base)
    lib = _Lib()
    _fake(monkeypatch, lib)
    before = slices.granule_totals.launches
    got = slices.granule_totals(lo, hi, mask, gran)
    assert slices.granule_totals.launches == before + 1
    assert lib.calls == [("KO", n)]
    assert torch.equal(got, slices.granule_totals_plain(lo, hi, mask, gran))
    got = slices.granule_totals(lo[:0], hi[:0], mask[:0], gran)
    assert got.numel() == 0 and slices.granule_totals.launches == before + 1
