"""The merge-join window index on one device: one trim window's sorted keys
and suffix order, joined to the probes afterwards.

Counterpart of ``DeviceWindowIndex``, ``window_arrays_from_codes`` and
``build_window_arrays`` (asgart_tpu/device_index.py:1298-1435) at k = 2..20,
and of the probe-key cache ``_PROBE_KEYS_CACHE``
(asgart_tpu/device_engine.py:2306). Build steps and their kernels:

  KA pack_keys (window mode, no probe rows) -> sort_keys (torch.sort)
  -> KB group_bounds (every row direct) -> KC invert_fused (no lanes)
  -> ties.resolve_ties (KE, KF) -> KG offset_slots (ws > 0)

Unlike the fused build, the probes are not sorted into the index: the
engine packs them apart (KA's probe-only mode) and joins them to the
sorted keys (KH ``mj_ranges``), so the sorted key (8 B/row) and ``sa``
(4 B/row) stay resident. The key is one int64 word (k <= 20, flag bit 0),
the fused build's one-word key; wider probes have no merge-join route, as
in the JAX package (its window engines are two-plane).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .codes import upload_codes
from .fused_index import MJ_MAX_K, sort_keys
from .kernels import group_bounds, invert_fused, offset_slots, pack_keys
from .ties import resolve_ties


def window_arrays_from_codes(codes: torch.Tensor, k: int, W: int,
                             ws: int = 0):
    """(skey int64 [W], sa int32 [W]) of the window text ``codes[ws:ws + W
    - 1]`` plus its '$': the sorted keys and the WINDOW-RELATIVE suffix
    order (positions 0..W-1), as ``window_arrays_from_codes`` gives its
    (key_hi, key_lo) and ``sa``."""
    (key,), _ = pack_keys(codes, (), k, False, False, W, 0, ws)
    (skey,), sa = sort_keys([key])
    run_lo, run_hi, tied = group_bounds([skey], sa, W)
    rank, _, _, _ = invert_fused(
        sa, run_lo, run_hi, torch.zeros(0, dtype=torch.bool,
                                        device=sa.device), W, [0])
    del run_lo, run_hi
    return skey, resolve_ties(sa, rank, tied, W, k)


def build_window_arrays(codes: torch.Tensor, k: int, ws: int, we: int):
    """(skey, sa, W) of the trim window ``strand[ws:we] + '$'`` (W = we -
    ws + 1 rows): the window-relative order of
    :func:`window_arrays_from_codes`, then KG turns it into genome
    positions (a separate step, so an engine that keeps window-relative
    positions can skip it)."""
    W = we - ws + 1
    skey, sa = window_arrays_from_codes(codes, k, W, ws)
    if ws:
        offset_slots(sa, ws)
    return skey, sa, W


@dataclass
class WindowRanges:
    """Stage 1 of the merge-join engine: every chunk's probe lanes, each
    with its window [lane_lo, lane_hi) of slots in the sorted window."""

    lane_lo: torch.Tensor    # int32 [total], 0 where masked
    lane_hi: torch.Tensor    # int32 [total]
    lane_mask: torch.Tensor  # bool [total] live-probe mask
    specs: tuple             # ((chunk_start, chunk_len, n_lanes), ...)
    offs: dict               # (chunk_start, chunk_len) -> (lane_offset,
    #                          raw match total)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.lane_lo, self.lane_hi, self.lane_mask))


@dataclass
class DeviceWindowIndex:
    """Device-resident merge-join index of one trim window: the window's
    sorted k-mer keys and its suffix order, aligned slot for slot (tie
    resolution permutes only inside equal-key runs)."""

    key: torch.Tensor        # int64 [W] sorted keys, (hi << 31) | (lo << 1)
    sa: torch.Tensor         # int32 [W] suffix order, genome positions
    k: int
    n: int                   # doubled text length (probe addressing)
    first_len: int           # genome + '$' length
    W: int                   # window text length incl. its own '$'
    win_start: int
    win_end: int
    reverse: bool
    complement: bool
    # the last stage 1 joined against this index, kept with it so that a
    # rescan of the same chunks skips the pack and the join
    stage1: WindowRanges | None = None

    def nbytes(self) -> int:
        held = self.key.numel() * 8 + self.sa.numel() * 4
        return held + (self.stage1.nbytes() if self.stage1 else 0)

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int, trim: tuple,
              reverse: bool, complement: bool, device: torch.device,
              codes: torch.Tensor | None = None) -> "DeviceWindowIndex":
        """The index of ``strand[ws:we] + '$'`` for ``trim`` = (ws, we).
        ``codes``: the strand's codes already on ``device``."""
        if not 2 <= k <= MJ_MAX_K:
            raise ValueError(f"merge-join window index supports probe_size "
                             f"2..{MJ_MAX_K}")
        ws, we = int(trim[0]), int(trim[1])
        n1 = int(len(strand_data))
        if not 0 <= ws < we <= n1 - 1:
            raise ValueError(f"bad trim window {trim}")
        n = 2 * n1 - 1 if (reverse or complement) else n1
        if n >= (1 << 31):
            raise ValueError("genome too large for int32 probe addressing")
        if codes is None:
            codes = upload_codes(strand_data, device)
        skey, sa, W = build_window_arrays(codes, k, ws, we)
        return cls(key=skey, sa=sa, k=k, n=n, first_len=n1, W=W,
                   win_start=ws, win_end=we, reverse=reverse,
                   complement=complement)


class ProbeKeyCache:
    """One-entry cache of packed probe keys (KA's probe-only mode): they
    do not depend on the window, so a sharded run's windows join the same
    keys and only the first window packs them. A sharded run makes one for
    its strand and drops it at its end, so the key holds the packing
    arguments but no strand fingerprint."""

    def __init__(self):
        self._key = None
        self._keys = None

    def get_or_pack(self, key: tuple, pack):
        if key != self._key:
            self._key = self._keys = None
            self._keys = pack()
            self._key = key
        return self._keys
