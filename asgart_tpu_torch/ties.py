"""Tie resolution of the fused index: prefix doubling on the tied subset.

Counterpart of ``_resolve_ties`` (asgart_tpu/device_index.py:807) with
``_extract_tied`` (:642), ``_slot_payload`` (:682) and ``_doubling_rounds``
(:696), built from PyTorch operations (a hand kernel is later work).

Tied slots are direct rows whose k-mer (key) group has more than one
direct entry. Manber-Myers rounds refine them: sort each tied group by
the rank of the suffix h symbols further on, scatter the positions back
into the group's (ascending) slots, give every new sub-run the slot of
its start as rank, keep only entries still tied, and double h. The
fused build's tied set never leaves the subset form (the JAX package's
full-array rounds and its ``FusedTiedOverflow`` bail-out are not needed:
subset rounds are exact at any tied count).

Reads of ``rank[p + h]`` stay inside the direct text: two distinct
suffixes tied on their first h symbols contain no '$' there (it is
unique; the k-mer keys pad with its rank 0), so p + h <= W - 1. The JAX
package clamps the read instead; here the bound is checked every round
and a violation raises.
"""

from __future__ import annotations

import torch


def resolve_ties(sa: torch.Tensor, rank: torch.Tensor,
                 tied_slot: torch.Tensor, M: int, k: int) -> torch.Tensor:
    """Refine ``sa`` (int32 [M], updated in place and returned) until no
    direct suffix is tied. ``rank`` (int32 [W], plain position layout,
    updated in place) holds each direct position's group start slot."""
    W = rank.numel()
    slots = torch.nonzero(tied_slot).flatten()  # ascending
    if slots.numel() == 0:
        return sa
    ps = sa[slots].long()
    prims = rank[ps].long()
    h = k
    while h < 2 * M:
        ph = ps + min(h, M)
        if bool((ph >= W).any()):
            raise RuntimeError(
                "tie resolution read past the direct text (a tied suffix "
                "spans the unique '$'); the strand is not genome + '$'")
        sec = rank[ph]
        key = (prims << 32) | (sec.long() + 1)
        skey, order = torch.sort(key, stable=True)
        p_sorted = ps[order]
        sa[slots] = p_sorted.to(torch.int32)
        new_run = torch.ones_like(skey, dtype=torch.bool)
        new_run[1:] = skey[1:] != skey[:-1]
        rs = torch.cummax(torch.where(new_run, slots, -1), 0).values
        rank[p_sorted] = rs.to(torch.int32)
        same = rs[1:] == rs[:-1]
        still = torch.zeros_like(new_run)
        still[:-1] |= same
        still[1:] |= same
        slots, ps, prims = slots[still], p_sorted[still], rs[still]
        if slots.numel() == 0:
            break
        h = min(2 * h, 2 * M)
    return sa
