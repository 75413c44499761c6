"""KE ``tie_keys`` and KF ``tie_refine``: one round of prefix doubling on
the tied subset, KE with the round's sort (each tied group sorted by the
kernel, or the keys sorted by the library where a group passes
``TIE_SORT_CAP``), KF after it; KK ``full_round_keys`` and KL
``full_round_refine``: one round over every row of a table build, around
the library's sort.

Kernels: ``csrc/ties.cu`` (see its header for what they replace in the
JAX package and how they are bounded); KL's random store ``rank[new_sa] =
s`` runs through KC's partitioned scatter with no lanes
(``csrc/invert.cu``, its scratch :func:`~.invert.kc_plan` (n, n)). Each
``<name>_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from . import _build
from .invert import kc_plan


def _check(name, *pairs):
    for t, dt in pairs:
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: bad dtype or layout")


# the largest tied group KE's sort takes (csrc/ties.cu kRegGroup: what a
# warp sorts in registers): a round whose largest group is longer, or not
# known, takes the library route
TIE_SORT_CAP = 128


def tie_keys(ps: torch.Tensor, prims: torch.Tensor, rank: torch.Tensor,
             h: int, bad: torch.Tensor, largest: int | None = None):
    """The round's sorted keys of the tied entries (positions ``ps``, group
    ranks ``prims``, int32 [n], ``prims`` non-decreasing: each group a run
    of at least two entries): (skey, order), int64 [n] each, what
    ``torch.sort(key, stable=True)`` gives for ``key = (prims << 32) |
    (rank[ps + h] + 1)``; ``rank`` is int32 [W]. An entry with ``ps + h >=
    W`` ORs 1 into ``bad`` (int32 [1], never cleared here) and reads
    ``rank[W - 1]``. ``largest``: the round's largest group (KE's sizing
    pass before the first round, KF's figure of the round before after
    it), None where not known. Up to ``TIE_SORT_CAP`` the kernel sorts
    each group itself; else KE writes the keys and ``torch.sort`` sorts
    them (the library route). A ``largest`` below the true one is a
    caller's fault: a longer group is left unsorted (each entry its own
    key, ``order[i] = i``) and ORs 2 into ``bad``."""
    n = ps.numel()
    _check("tie_keys", (ps, torch.int32), (prims, torch.int32),
           (rank, torch.int32), (bad, torch.int32))
    if prims.numel() != n or bad.numel() != 1 or not 0 <= h < 2**31:
        raise ValueError("tie_keys: bad shapes or h")
    if not _build.on_cuda(ps, prims, rank, bad):
        return tie_keys_plain(ps, prims, rank, h, bad)
    lib = _build.lib()
    stream = _build.stream_of(ps)
    if largest is None or largest > TIE_SORT_CAP:
        key = torch.empty(n, dtype=torch.int64, device=ps.device)
        tie_keys.launches += 1
        _build.check(lib.asgart_tie_keys(
            ps.data_ptr(), prims.data_ptr(), rank.data_ptr(), n,
            rank.numel(), h, key.data_ptr(), bad.data_ptr(), stream),
            "tie_keys")
        return torch.sort(key, stable=True)
    skey, order = (torch.empty(n, dtype=torch.int64, device=ps.device)
                   for _ in range(2))
    if n == 0:
        return skey, order
    tie_keys.launches += 1
    _build.check(lib.asgart_tie_sort(
        ps.data_ptr(), prims.data_ptr(), rank.data_ptr(), n, rank.numel(),
        h, skey.data_ptr(), order.data_ptr(), bad.data_ptr(), stream),
        "tie_keys")
    return skey, order


tie_keys.launches = 0


def tie_groups(prims: torch.Tensor, largest: torch.Tensor) -> None:
    """KE's sizing pass: writes the longest run of equal ``prims`` (int32
    [n], non-decreasing), the round's largest group, into ``largest``
    (int32 [1]) on the device; 0 for n = 0."""
    _check("tie_groups", (prims, torch.int32), (largest, torch.int32))
    if largest.numel() != 1:
        raise ValueError("tie_groups: largest must hold one word")
    if not _build.on_cuda(prims, largest):
        return tie_groups_plain(prims, largest)
    lib = _build.lib()
    tie_groups.launches += 1
    _build.check(lib.asgart_tie_groups(
        prims.data_ptr(), prims.numel(), largest.data_ptr(),
        _build.stream_of(prims)), "tie_groups")


tie_groups.launches = 0


def tie_groups_plain(prims, largest):
    """Plain PyTorch version of KE's sizing pass."""
    n = prims.numel()
    if n == 0:
        largest.zero_()
        return
    starts = torch.ones(n, dtype=torch.bool, device=prims.device)
    starts[1:] = prims[1:] != prims[:-1]
    at = torch.nonzero(starts).flatten()
    largest.copy_(torch.diff(at, append=at.new_tensor([n])).max())


def tie_keys_plain(ps, prims, rank, h, bad, largest=None):
    """Plain PyTorch version of the KE kernel: the keys, then the library's
    stable sort (``largest`` is not needed)."""
    W = rank.numel()
    ph = ps.long() + h
    bad |= (ph >= W).any().to(torch.int32)
    sec = rank[ph.clamp(max=W - 1)].long()
    return torch.sort((prims.long() << 32) | (sec + 1), stable=True)


# csrc/ties.cu kRefTile: KF's entries a tile of its compaction scan
TIE_TILE = 256


def tie_refine(skey: torch.Tensor, order: torch.Tensor, slots: torch.Tensor,
               ps: torch.Tensor, sa: torch.Tensor, rank: torch.Tensor,
               count: torch.Tensor):
    """Apply one sorted round (``skey`` int64 [n] sorted, ``order`` int64
    [n] its source entries) to the tied entries at ``slots`` (int32 [n],
    ascending) with positions ``ps`` (int32 [n]): writes ``sa[slots[r]] =
    ps[order[r]]`` and each position's new rank, the slot of its sub-run
    start, into ``rank``, both in place; an entry is still tied when its
    sub-run is longer than one.

    Returns the still-tied entries' next (slots, ps, prims), int32 [n]
    each, compacted in entry order (slots ascending) into their first
    ``m`` entries, and writes m into ``count[0]`` (int32 [2]) on the
    device and the longest still-tied sub-run (the next round's largest
    group; 0 if none) into ``count[1]``: the caller reads them with the
    round's other flag."""
    n = skey.numel()
    _check("tie_refine", (skey, torch.int64), (order, torch.int64),
           (slots, torch.int32), (ps, torch.int32), (sa, torch.int32),
           (rank, torch.int32), (count, torch.int32))
    if order.numel() != n or slots.numel() != n or ps.numel() != n \
            or count.numel() != 2:
        raise ValueError("tie_refine: entry arrays differ in length")
    if not _build.on_cuda(skey, order, slots, ps, sa, rank, count):
        return tie_refine_plain(skey, order, slots, ps, sa, rank, count)
    dev = skey.device
    outs = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in range(3))
    if n == 0:
        count.zero_()
        return outs
    tiles = -(-n // TIE_TILE)
    scratch = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    lib = _build.lib()
    tie_refine.launches += 1
    _build.check(lib.asgart_tie_refine(
        skey.data_ptr(), order.data_ptr(), slots.data_ptr(), ps.data_ptr(),
        n, sa.data_ptr(), rank.data_ptr(), *(t.data_ptr() for t in outs),
        count.data_ptr(), count.data_ptr() + 4, scratch.data_ptr(), tiles,
        _build.stream_of(skey)), "tie_refine")
    return outs


tie_refine.launches = 0


def tie_refine_plain(skey, order, slots, ps, sa, rank, count):
    """Plain PyTorch version of the KF kernel (the JAX package's cummax
    of sub-run start slots, then its stable partition of the still-tied
    entries; the outputs past the count are zeros)."""
    n = skey.numel()
    p_sorted = ps[order]
    new_run = torch.ones_like(skey, dtype=torch.bool)
    new_run[1:] = skey[1:] != skey[:-1]
    rs = torch.cummax(torch.where(new_run, slots.long(), -1), 0).values
    rs = rs.to(torch.int32)
    sa[slots.long()] = p_sorted
    rank[p_sorted.long()] = rs
    same = rs[1:] == rs[:-1]
    still = torch.zeros_like(new_run)
    still[:-1] |= same
    still[1:] |= same
    outs = tuple(torch.zeros(n, dtype=torch.int32, device=skey.device)
                 for _ in range(3))
    for out, x in zip(outs, (slots, p_sorted, rs)):
        kept = x[still]
        out[:kept.numel()] = kept
    starts = torch.nonzero(new_run).flatten()  # the longest still-tied run
    runs = torch.diff(starts, append=starts.new_tensor([n]))
    longest = int(runs.max()) if n else 0
    count[0] = int(still.sum())
    count[1] = longest if longest > 1 else 0
    return outs


def full_round_keys(rank: torch.Tensor, h: int,
                    direct_bound: int) -> torch.Tensor:
    """Round keys of every position q of the text over its ranks ``rank``
    (int32 [n]), in position order: ``(rank[q] << 32) | ((q >=
    direct_bound) << 31) | (sec + 1)``, sec = rank[q + h] when q < n - h,
    else -1 (int64 [n]). Sorted stably, they give the round's new order
    (the sort's permutation) where the current order keeps each run of
    equal rank in ascending positions (``ties.full_rounds``)."""
    n = rank.numel()
    _check("full_round_keys", (rank, torch.int32))
    if not 0 <= h <= n or not 0 <= direct_bound <= n:
        raise ValueError("full_round_keys: bad h or direct_bound")
    if not _build.on_cuda(rank):
        return full_round_keys_plain(rank, h, direct_bound)
    key = torch.empty(n, dtype=torch.int64, device=rank.device)
    lib = _build.lib()
    full_round_keys.launches += 1
    _build.check(lib.asgart_full_round_keys(
        rank.data_ptr(), n, h, direct_bound, key.data_ptr(),
        _build.stream_of(rank)), "full_round_keys")
    return key


full_round_keys.launches = 0


def full_round_keys_plain(rank, h, direct_bound):
    """Plain PyTorch version of the KK kernel (the JAX ``_full_round``'s
    sort keys, packed, in position order)."""
    n = rank.numel()
    q = torch.arange(n, device=rank.device)
    sec = torch.full((n,), -1, dtype=torch.int64, device=rank.device)
    sec[:n - h] = rank[h:].long()
    return (rank.long() << 32) | ((q >= direct_bound).long() << 31) \
        | (sec + 1)


def full_round_refine(skey: torch.Tensor, order: torch.Tensor,
                      rank: torch.Tensor, direct_bound: int):
    """Apply one sorted full round (``skey`` int64 [n] sorted, ``order``
    int64 [n] its source rows: positions, since KK's keys are in position
    order): the new order ``order`` as int32, each position's new rank,
    the slot of its run start in ``skey``, written into ``rank`` (int32
    [n]) in place.

    Returns (new_sa int32 [n], tied bool [n]): tied marks rows of runs
    longer than one whose position is below ``direct_bound``."""
    n = skey.numel()
    _check("full_round_refine", (skey, torch.int64), (order, torch.int64),
           (rank, torch.int32))
    if order.numel() != n or rank.numel() != n:
        raise ValueError("full_round_refine: arrays differ in length")
    if not _build.on_cuda(skey, order, rank):
        return full_round_refine_plain(skey, order, rank, direct_bound)
    dev = skey.device
    new_sa = torch.empty(n, dtype=torch.int32, device=dev)
    tied = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return new_sa, tied
    # KC with no lanes (M = W = n): its scratch, the in-order pass's run
    # starts in the second partition pass's run_lo plane (the first pass
    # reads them before the second writes there)
    plan = kc_plan(n, n)
    scratch = torch.empty(plan.words, dtype=torch.int32, device=dev)
    sp = scratch.data_ptr()
    d1, l1, d2, l2 = (sp + 4 * w for w in (plan.d1_at, plan.l1_at,
                                           plan.d2_at, plan.l2_at))
    stream = _build.stream_of(skey)
    lib = _build.lib()
    full_round_refine.launches += 1
    _build.check(lib.asgart_full_round_refine(
        skey.data_ptr(), order.data_ptr(), n, direct_bound,
        new_sa.data_ptr(), l2, tied.data_ptr(), stream), "full_round_refine")
    _build.check(lib.asgart_invert_fused(
        new_sa.data_ptr(), l2, l2, None, n, n, None, 0, 0, sp, plan.coarse,
        plan.tiles, d1, l1, None, 0, d2, l2, None, 0, rank.data_ptr(), None,
        None, None, stream), "full_round_refine")
    return new_sa, tied


full_round_refine.launches = 0


def full_round_refine_plain(skey, order, rank, direct_bound):
    """Plain PyTorch version of the KL kernel (the JAX ``_full_round``'s
    cummax of run starts, inverse-permutation scatter and tied flags)."""
    n = skey.numel()
    new_sa = order.to(torch.int32)
    new_run = torch.ones(n, dtype=torch.bool, device=skey.device)
    new_run[1:] = skey[1:] != skey[:-1]
    iota = torch.arange(n, device=skey.device)
    rs = torch.cummax(torch.where(new_run, iota, 0), 0).values
    rank[order] = rs.to(torch.int32)
    same = rs[1:] == rs[:-1]
    tied = torch.zeros(n, dtype=torch.bool, device=skey.device)
    tied[:-1] |= same
    tied[1:] |= same
    return new_sa, tied & (order < direct_bound)
