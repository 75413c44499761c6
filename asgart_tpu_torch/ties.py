"""Tie resolution of the fused index: prefix doubling on the tied subset.

Counterpart of ``_resolve_ties`` (asgart_tpu/device_index.py:807) with
``_extract_tied`` (:642), ``_slot_payload`` (:682) and ``_doubling_rounds``
(:696). Each round is KE ``tie_keys``, a stable library sort of the round
keys, KF ``tie_refine`` (kernels/ties.py), then a compaction of the
entries still tied.

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
package clamps the read instead; here KE flags a violation on the device,
the flag is read once per round together with the still-tied count (the
round's one host sync), and a violation raises.
"""

from __future__ import annotations

import torch

from .kernels import tie_keys, tie_refine


def resolve_ties(sa: torch.Tensor, rank: torch.Tensor,
                 tied_slot: torch.Tensor, M: int, k: int) -> torch.Tensor:
    """Refine ``sa`` (int32 [M], updated in place and returned) until no
    direct suffix is tied. ``rank`` (int32 [W], plain position layout,
    updated in place) holds each direct position's group start slot."""
    slots = torch.nonzero(tied_slot).flatten()  # ascending
    if slots.numel() == 0:
        return sa
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(torch.int32)
    bad = torch.zeros(1, dtype=torch.int32, device=sa.device)
    h = k
    while h < 2 * M:
        key = tie_keys(ps, prims, rank, min(h, M), bad)
        skey, order = torch.sort(key, stable=True)
        del key
        ps, prims, still = tie_refine(skey, order, slots, ps, sa, rank)
        del skey, order
        pos = torch.cumsum(still, 0)
        n_still, violated = torch.stack((pos[-1], bad[0].long())).tolist()
        if violated:
            raise RuntimeError(
                "tie resolution read past the direct text (a tied suffix "
                "spans the unique '$'); the strand is not genome + '$'")
        if n_still == 0:
            break
        dest = torch.where(still, pos - 1, n_still)
        slots, ps, prims = (_compact(x, dest, n_still)
                            for x in (slots, ps, prims))
        h = min(2 * h, 2 * M)
    return sa


def _compact(x: torch.Tensor, dest: torch.Tensor, n: int) -> torch.Tensor:
    """The entries of ``x`` whose ``dest`` is below ``n``, at ``dest`` (an
    order-keeping compaction; the rest land in a dropped last slot)."""
    out = torch.empty(n + 1, dtype=x.dtype, device=x.device)
    out.scatter_(0, dest, x)
    return out[:n]
