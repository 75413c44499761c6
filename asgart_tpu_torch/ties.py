"""Tie resolution of the device indexes: prefix doubling on the tied subset,
after full-array rounds while a table build's tied set is large.

Counterpart of ``_resolve_ties`` (asgart_tpu/device_index.py:807) with
``_extract_tied`` (:642), ``_slot_payload`` (:682) and ``_doubling_rounds``
(:696). Each round is KE ``tie_keys``, which gathers the round's keys and
sorts each tied group stably itself, and KF ``tie_refine``
(kernels/ties.py), which also compacts the entries still tied, counts
them and finds the longest still-tied sub-run on the device, as the JAX
round's stable partition does. That longest sub-run is the next round's
largest group. The first round's comes from KE's sizing pass
``tie_groups``, read once before the loop, where the tied set has at
least ``SIZING_MIN`` entries; a smaller first round takes the library
route unsized. A round whose largest group passes
``kernels.ties.TIE_SORT_CAP``, or is not known, takes KE's key pass and
the library's stable sort instead (a choice by size, made before the
launch). A table build (table_index.py) passes ``tied_cap``:
while more than that many rows are tied, a full round (``_full_round``,
:769) runs first: KK ``full_round_keys`` (every position's keys, in
position order), the stable sort, KL ``full_round_refine``, over every
row, appended ones included, so that the order of the appended half's
rows is the JAX package's too. They rest on the position-order invariant
(:func:`full_rounds`): within each run of equal rank, the order ascends
by position.

Tied slots are direct rows whose k-mer (key) group has more than one
direct entry. Manber-Myers rounds refine them: sort each tied group by
the rank of the suffix h symbols further on, scatter the positions back
into the group's (ascending) slots, give every new sub-run the slot of
its start as rank, keep only entries still tied, and double h. The
fused and merge-join builds' tied sets never leave the subset form (the
JAX fused build's ``FusedTiedOverflow`` bail-out is not needed: subset
rounds are exact at any tied count); only the table build, whose appended
rows the full rounds reorder, runs them.

Reads of ``rank[p + h]`` stay inside the direct text: two distinct
suffixes tied on their first h symbols contain no '$' there (it is
unique; the k-mer keys pad with its rank 0), so p + h <= W - 1. The JAX
package clamps the read instead; here KE flags a violation on the device,
the flag is read once per round together with KF's still-tied count and
longest sub-run (the round's one host sync), and a violation raises.
"""

from __future__ import annotations

import torch

from .kernels import (full_round_keys, full_round_refine, tie_groups,
                      tie_keys, tie_refine)

# The tied entries from which the first round's largest group is found
# (KE's sizing pass and a host read before the loop) so that the round may
# take KE's sort. On an NVIDIA H100 the read took 0.15-0.33 ms on the host
# clock; the library route's first round 0.24 ms on 1.2 M entries (KE's
# sort 0.07 where every group fits: a gain no larger than the read) and
# 1.92 ms on 12.3 M (KE's sort 0.53); scripts/ke_ko_probe.py.
SIZING_MIN = 1 << 22


def full_rounds(sa: torch.Tensor, rank: torch.Tensor, tied_slot: torch.Tensor,
                k: int, tied_cap: int, direct_bound: int):
    """Full-array rounds over the n rows of a table build (``sa``, ``rank``
    int32 [n], ``rank`` updated in place) while more than ``tied_cap`` rows
    are tied, as the JAX ``_resolve_ties`` runs them. Returns (sa,
    tied_slot, h): the new order, its tied rows and the next round's h.

    Precondition: within each run of equal rank, ``sa`` ascends by
    position. The build's first sort is stable over keys made in position
    order, and every round is a stable sort whose equal keys share a rank,
    so the property holds for the order each round starts from. The JAX
    round sorts (rank, flag, sec) stably in the current order; with the
    precondition, its ties fall in position order, so sorting the same
    keys made in position order (KK) gives the same result, and the sort's
    permutation is the new order. A round thus never reads ``sa``: once
    the first round runs, ``sa`` and ``tied_slot`` are emptied in place
    (``set_()``), so that their memory is free for the sort whatever
    references the caller holds, and the returned ones replace them."""
    n = rank.numel()
    n_tied = int(tied_slot.sum())
    h = k
    while n_tied > tied_cap and h < 2 * n:
        key = full_round_keys(rank, min(h, n), direct_bound)
        sa.set_()
        tied_slot.set_()
        skey, order = torch.sort(key, stable=True)
        del key
        sa, tied_slot = full_round_refine(skey, order, rank, direct_bound)
        del skey, order
        h = min(2 * h, 2 * n)
        n_tied = int(tied_slot.sum())
    return sa, tied_slot, h


def resolve_ties(sa: torch.Tensor, rank: torch.Tensor,
                 tied_slot: torch.Tensor, M: int, k: int,
                 tied_cap: int | None = None, direct_bound: int | None = None
                 ) -> torch.Tensor:
    """Refine ``sa`` (int32 [M], updated in place and returned unless full
    rounds replace it: they empty it and ``tied_slot``, see
    :func:`full_rounds`) until no direct suffix is tied. ``rank`` (int32,
    plain position layout, updated in place) holds each position's group
    start slot: [W] for the fused and merge-join builds; [M] for a table
    build, which passes ``tied_cap`` (full rounds first while more rows
    are tied) and ``direct_bound`` (n1: the appended half's positions start
    there; M for a text without one)."""
    h = k
    if tied_cap is not None:
        sa, tied_slot, h = full_rounds(sa, rank, tied_slot, k, tied_cap,
                                       direct_bound)
        rank = rank[:direct_bound]  # tied suffixes read no appended rank
    slots = torch.nonzero(tied_slot).flatten()  # ascending
    if slots.numel() == 0:
        return sa
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(torch.int32)
    # KE's bad flag, KF's still-tied count and its longest still-tied
    # sub-run: the round's one host read
    flags = torch.zeros(3, dtype=torch.int32, device=sa.device)
    largest = None  # the first round's largest group, where it pays
    if slots.numel() >= SIZING_MIN:
        tie_groups(prims, flags[2:])
        (largest,) = flags[2:].tolist()
    while h < 2 * M:
        skey, order = tie_keys(ps, prims, rank, min(h, M), flags[:1],
                               largest)
        slots, ps, prims = tie_refine(skey, order, slots, ps, sa, rank,
                                      flags[1:])
        del skey, order
        violated, n_still, largest = flags.tolist()
        if violated & 2:
            raise RuntimeError(
                "tie resolution handed KE's sort a group longer than "
                "kernels.ties.TIE_SORT_CAP (a fault of the round's route)")
        if violated:
            raise RuntimeError(
                "tie resolution read past the direct text (a tied suffix "
                "spans the unique '$'); the strand is not genome + '$'")
        if n_still == 0:
            break
        slots, ps, prims = (x[:n_still] for x in (slots, ps, prims))
        h = min(2 * h, 2 * M)
    return sa
