"""numpy models of two kernels of asgart_tpu_torch/csrc, step by step as
the card runs them, for the CPU tests (tests/test_torch_ke_ko_host.py,
tests/test_torch_ties.py):

- KE's sort (csrc/ties.cu ``tie_sort_kernel``): tiles of ``SORT_TILE``
  entries a block, ``SUB`` a warp; the warp path's windows of 32 lanes
  from a group start, their complete groups sorted by the key (group start
  lane, sec, lane) with an odd-even transposition sort of g steps (g the
  window's largest group, g < ``OETS``) or the 32-lane bitonic network; a
  group with no end in its window (its end found by the warp's 32-probe
  search) sorted by the warp that finds it in registers, entry e = r * 32
  + lane keyed (sec << 8) | e, by the bitonic network over 64 or 128 keys,
  up to ``REG_GROUP`` entries (the capacity); a longer group is written
  unsorted (each entry its own key, order[i] = i) and ORs 2 into bad
  (the route keeps such rounds away); a read past the text ORs 1 into it;
- KO (csrc/slices.cu ``granule_totals_kernel``): a warp a granule, the
  lanes before the first 16-byte aligned lane and after the last whole
  vector as scalars, 4-lane vectors between, or every lane a scalar where
  the three arrays' skews differ.
"""

import numpy as np

SORT_TILE = 256    # csrc/ties.cu kSortTile
SUB = 32           # kSub
TILE_WARPS = SORT_TILE // SUB  # kTileWarps
OETS = 15          # kOets
REG_GROUP = 128   # kRegGroup
GRAN_VEC = 4       # csrc/slices.cu: lanes a vector


def _lowest(mask):
    return (mask & -mask).bit_length() - 1 if mask else -1


def _highest(mask):
    return mask.bit_length() - 1


def oets(keys, steps):
    """``steps`` odd-even transposition steps over the 32 lanes, step q
    comparing lanes (l, l + 1) with (l - q) even."""
    keys = keys.copy()
    for q in range(steps):
        lo = np.arange(q & 1, 31, 2)
        a, b = keys[lo], keys[lo + 1]
        keys[lo], keys[lo + 1] = np.minimum(a, b), np.maximum(a, b)
    return keys


def bitonic(keys):
    """The bitonic network over len(keys) (32, 64 or 128) keys, ascending:
    entry e keeps the smaller of its key and entry e ^ j's where (e & j ==
    0) == (e & k == 0)."""
    ln = np.arange(len(keys))
    k = 2
    while k <= len(keys):
        j = k >> 1
        while j:
            o = keys[ln ^ j]
            keep_min = ((ln & j) == 0) == ((ln & k) == 0)
            keys = np.where(keep_min, np.minimum(keys, o),
                            np.maximum(keys, o))
            j >>= 1
        k <<= 1
    return keys


class SortRecord:
    """What the model saw: the windows' transposition step counts (and
    -1 for a bitonic network), the groups sorted in registers, and the
    groups past the capacity (left unsorted: the kernel ORs 2 into
    bad)."""

    def __init__(self):
        self.steps = []
        self.regs = []
        self.big = []


def _secs(ps, rank, h, W, g0, s, bad):
    """sec of the entries [g0, g0 + s), 1 ORed into bad where one reads past
    the text."""
    ph = ps[g0:g0 + s].astype(np.int64) + h
    if (ph >= W).any():
        bad[0] |= 1
    return rank[np.minimum(ph, W - 1)].astype(np.uint64)


def _group_end(prims, n, pos):
    """The warp's search for one past the group holding [pos, pos + 32):
    32 probes a step, the step 32 times the last until one leaves the
    group, then 32 times narrower."""
    lo, step = pos + 31, 1

    def diff(q, top):
        return q >= top or prims[q] != prims[pos]

    while True:
        probe = [diff(lo + step * (ln + 1), n) for ln in range(32)]
        if any(probe):
            f = probe.index(True)
            lo, hi = lo + step * f, lo + step * (f + 1)
            break
        lo += 32 * step
        step *= 32
    hi = min(hi, n)
    while hi - lo > 1:
        step = -(-(hi - lo) // 32)
        probe = [diff(lo + step * (ln + 1), hi) for ln in range(32)]
        f = probe.index(True)
        lo, hi = lo + step * f, min(lo + step * (f + 1), hi)
    return hi


def _regs_group(ps, rank, h, W, g0, s, prim, skey, order, bad, rec):
    """The warp's register sort of [g0, g0 + s): keys (sec << 8) | e over
    64 or 128 entries (the rest the largest key), the bitonic network."""
    size = 64 if s <= REG_GROUP // 2 else REG_GROUP
    sec = _secs(ps, rank, h, W, g0, s, bad)
    keys = np.full(size, np.iinfo(np.uint64).max, np.uint64)
    keys[:s] = (sec << np.uint64(8)) | np.arange(s, dtype=np.uint64)
    ks = bitonic(keys)[:s]
    skey[g0:g0 + s] = (np.int64(prim) << np.int64(32)) | \
        ((ks >> np.uint64(8)).astype(np.int64) + 1)
    order[g0:g0 + s] = g0 + (ks & np.uint64(255)).astype(np.int64)
    rec.regs.append(s)


def model_tie_sort(ps, prims, rank, h, rec=None):
    """(skey, order, bad) as KE's sort writes them for the tied entries
    (numpy int32 ps, prims; rank int32 [W])."""
    rec = SortRecord() if rec is None else rec
    n, W = len(ps), len(rank)
    skey = np.full(n, -7, np.int64)
    order = np.full(n, -7, np.int64)
    bad = np.zeros(1, np.int32)
    start = np.ones(n, bool)
    start[1:] = prims[1:] != prims[:-1]
    # the plain model's precondition: no group of one entry
    nxt = np.append(start[1:], True)
    assert not (start & nxt).any(), "a tied group of one entry"
    for blk in range(-(-n // SORT_TILE)):
        for w in range(TILE_WARPS):
            sub_lo = blk * SORT_TILE + w * SUB
            sub_hi = min(sub_lo + SUB, n)
            at = np.flatnonzero(start[sub_lo:sub_hi]) if sub_lo < n else []
            pos = sub_lo + int(at[0]) if len(at) else None
            while pos is not None and pos < sub_hi:
                i = pos + np.arange(32)
                valid = i < n
                iv = np.minimum(i, n - 1)
                end = valid & np.append(start[1:], True)[iv]
                own = valid & (i < sub_hi) & start[iv]
                own[0] = True
                E = int(sum(1 << l for l in np.flatnonzero(end)))
                S = int(sum(1 << l for l in np.flatnonzero(own)))
                last = _highest(S)
                after = E & (0xFFFFFFFF << last) & 0xFFFFFFFF
                m = _lowest(after) + 1 if after else last
                if m == 0:  # no end in the window
                    e = _group_end(prims, n, pos)
                    args = (ps, rank, h, W, pos, e - pos, prims[pos], skey,
                            order, bad, rec)
                    if e - pos <= REG_GROUP:
                        _regs_group(*args)
                    else:  # past the capacity: the route's fault
                        sec = _secs(ps, rank, h, W, pos, e - pos, bad)
                        skey[pos:e] = (np.int64(prims[pos]) << 32) | \
                            (sec.astype(np.int64) + 1)
                        order[pos:e] = np.arange(pos, e)
                        rec.big.append(e - pos)
                        bad[0] |= 2
                    pos = e
                    continue
                sec = _secs(ps, rank, h, W, pos, m, bad)
                lanes = np.arange(m)
                st = np.array([_highest(S & ((2 << int(l)) - 1))
                               for l in lanes])
                size = np.array([_lowest(E & (0xFFFFFFFF << int(l))) for l in
                                 lanes]) - st + 1
                g = int(size.max())
                keys = np.full(32, np.iinfo(np.uint64).max, np.uint64)
                keys[:m] = (st.astype(np.uint64) << np.uint64(36)) | \
                    (sec << np.uint64(5)) | lanes.astype(np.uint64)
                if g < OETS:
                    keys = oets(keys, g)
                    rec.steps.append(g)
                else:
                    keys = bitonic(keys)
                    rec.steps.append(-1)
                ks = keys[:m]
                skey[pos:pos + m] = (prims[pos:pos + m].astype(np.int64)
                                     << 32) | (((ks >> np.uint64(5))
                                                & np.uint64(0x7FFFFFFF))
                                               .astype(np.int64) + 1)
                order[pos:pos + m] = pos + (ks & np.uint64(31)).astype(
                    np.int64)
                pos += m
    return skey, order, bad


def model_granule_totals(lo, hi, mask, gran, lo_at=0, hi_at=0, mask_at=0):
    """KO's totals (int64) from numpy lane arrays whose first lanes lie at
    byte offsets ``lo_at``, ``hi_at``, ``mask_at`` from a 16-byte boundary;
    also the count of lanes read as scalars."""
    n = len(lo)
    skew = (lo_at >> 2) & 3
    vec = lo_at % 4 == 0 and hi_at % 4 == 0 and (hi_at >> 2) & 3 == skew \
        and mask_at & 3 == skew
    d = np.where(mask, hi.astype(np.int64) - lo.astype(np.int64), 0)
    totals, scalars = [], 0
    for g in range(-(-n // gran)):
        a, b = g * gran, min(g * gran + gran, n)
        if not vec:
            totals.append(int(d[a:b].sum()))
            scalars += b - a
            continue
        v0 = min(a + ((4 - ((a + skew) & 3)) & 3), b)
        nv = (b - v0) >> 2
        tail = v0 + 4 * nv
        assert v0 - a <= 3 and b - tail <= 3
        assert nv == 0 or ((v0 + skew) % 4 == 0
                           and (mask_at + v0) % 4 == 0)
        s = int(d[a:v0].sum()) + int(d[tail:b].sum())
        scalars += (v0 - a) + (b - tail)
        quads = d[v0:tail].reshape(-1, GRAN_VEC)
        totals.append(s + int(quads.sum()))
    return np.array(totals, np.int64), scalars
