"""The merge-join window index on one device: one trim window's sorted keys
and suffix order, joined to the probes afterwards.

Counterpart of ``DeviceWindowIndex``, ``window_arrays_from_codes`` and
``build_window_arrays`` (asgart_tpu/device_index.py:1298-1435) at k = 2..20,
and of the probe-key cache ``_PROBE_KEYS_CACHE``
(asgart_tpu/device_engine.py:2306). Build steps and their kernels:

  KA pack_keys (window mode, no probe rows) -> sort_keys (torch.sort)
  -> KB group_bounds (every row direct) -> KC invert_fused (no lanes)
  -> ties.resolve_ties (KE, KF); then the key directory that KH searches
  from (``mj_directory``, at most 0.25 B a row), built once per index

The suffix order keeps window positions 0..W-1, as the JAX
``BigWindowEngine`` keeps them (asgart_tpu/device_engine.py:2453-2458),
and as the port's fused window build does; the engine adds the window
start to its matches in int64. So the index has no int32 bound on the
probed text and serves any genome size; a JAX ``DeviceWindowIndex`` (genome positions) is carried in
by subtracting its window start (convert.py).

Unlike the fused build, the probes are not sorted into the index: the
engine packs them apart (KA's probe-only mode) and joins them to the
sorted keys (KH ``mj_ranges``), so the sorted key (8 B/row), ``sa``
(4 B/row) and the directory stay resident. The key is one int64 word (k
<= 20, flag bit 0), the fused build's one-word key; wider probes have no
merge-join route, as in the JAX package (its window engines are
two-plane).

``ShardedWindowIndex`` is one rank's shard of such an index: a contiguous
run of its rows (the rank-sharded window engine, device_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .codes import upload_codes
from .fused_index import MJ_MAX_K, sort_keys
from .kernels import group_bounds, invert_fused, pack_keys
from .kernels.merge_join import MjDirectory, index_directory
from .ties import resolve_ties


def window_arrays_from_codes(codes: torch.Tensor, k: int, W: int,
                             ws: int = 0):
    """(skey int64 [W], sa int32 [W]) of the window text ``codes[ws:ws + W
    - 1]`` plus its '$': the sorted keys and the WINDOW-RELATIVE suffix
    order (positions 0..W-1), as ``window_arrays_from_codes`` gives its
    (key_hi, key_lo) and ``sa``."""
    keys, _ = pack_keys(codes, (), k, False, False, W, 0, ws)
    (skey,), sa = sort_keys(keys)  # frees the unsorted key
    run_lo, run_hi, tied = group_bounds([skey], sa, W)
    rank, _, _, _ = invert_fused(
        sa, run_lo, run_hi, torch.zeros(0, dtype=torch.bool,
                                        device=sa.device), W, [0])
    del run_lo, run_hi
    return skey, resolve_ties(sa, rank, tied, W, k)


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
    resolution permutes only inside equal-key runs), and the keys'
    directory."""

    key: torch.Tensor        # int64 [W] sorted keys, (hi << 31) | (lo << 1)
    sa: torch.Tensor         # int32 [W] suffix order: window positions
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
    # KH's key directory, built with the index (none on the CPU)
    directory: MjDirectory | None = field(init=False, default=None)

    def __post_init__(self):
        self.directory = index_directory(self.key, self.k)

    def nbytes(self) -> int:
        held = self.key.numel() * 8 + self.sa.numel() * 4
        return held + (self.directory.nbytes() if self.directory is not None else 0) \
            + (self.stage1.nbytes() if self.stage1 else 0)

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
        if codes is None:
            codes = upload_codes(strand_data, device)
        W = we - ws + 1
        skey, sa = window_arrays_from_codes(codes, k, W, ws)
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


@dataclass
class ShardedWindowIndex:
    """One rank's shard of a trim window's merge-join index: rows [row0,
    row0 + n_local) of the window's sorted keys and suffix order, row0 =
    r·Wl with Wl = ceil(W / D) (D ranks), as device d of the JAX
    ``ShardedWindowEngine`` holds rows [d·Wl, (d + 1)·Wl) of its stacked
    shards (asgart_tpu/device_engine.py:3295-3313), and the directory of
    those keys. No padding: the last shards are shorter, and a rank owns no
    row when r·Wl >= W."""

    key: torch.Tensor        # int64 [n_local] sorted keys (flag bit 0)
    sa: torch.Tensor         # int32 [n_local] window positions
    W: int                   # window rows, its '$' included
    Wl: int                  # rows a shard holds at most
    r: int                   # this rank
    D: int                   # ranks
    k: int
    first_len: int           # genome + '$' length
    win_start: int
    win_end: int
    reverse: bool
    complement: bool
    # the last stage 1 (after its all_reduce), kept as on DeviceWindowIndex
    stage1: WindowRanges | None = None
    # KH's directory of this shard's keys, built with the shard (none on
    # the CPU)
    directory: MjDirectory | None = field(init=False, default=None)

    def __post_init__(self):
        self.directory = index_directory(self.key, self.k)

    @property
    def row0(self) -> int:
        return min(self.W, self.r * self.Wl)

    def nbytes(self) -> int:
        held = self.key.numel() * 8 + self.sa.numel() * 4
        return held + (self.directory.nbytes() if self.directory is not None else 0) \
            + (self.stage1.nbytes() if self.stage1 else 0)

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int, trim: tuple,
              reverse: bool, complement: bool, device: torch.device,
              r: int, D: int, host_build: bool,
              codes: torch.Tensor | None = None) -> "ShardedWindowIndex":
        """Rank ``r``'s shard of the index of ``strand[ws:we] + '$'``. On
        the device (``codes``: the strand's codes on ``device``), the whole
        window is built as :meth:`DeviceWindowIndex.build` builds it, then
        cut to the shard and the rest freed; with ``host_build``, by
        ``host_window_arrays`` on the host (its two key planes packed into
        the one-word key), and only the shard is uploaded."""
        from .host_helpers import host_window_arrays

        if not 2 <= k <= MJ_MAX_K:
            raise ValueError(f"rank-sharded window index supports "
                             f"probe_size 2..{MJ_MAX_K}")
        ws, we = int(trim[0]), int(trim[1])
        n1 = int(len(strand_data))
        if not 0 <= ws < we <= n1 - 1:
            raise ValueError(f"bad trim window {trim}")
        if not 0 <= r < D:
            raise ValueError(f"bad rank {r} of {D}")
        W = we - ws + 1
        Wl = -(-W // D)
        a, b = min(W, r * Wl), min(W, (r + 1) * Wl)
        if host_build:
            key_hi, key_lo, _, sa, _ = host_window_arrays(strand_data, k,
                                                          ws, we)
            key = (key_hi[a:b].astype(np.int64) << 31) \
                | (key_lo[a:b].astype(np.int64) << 1)
            key = torch.from_numpy(key).to(device)
            sa = torch.from_numpy(np.ascontiguousarray(sa[a:b])).to(device)
        else:
            if codes is None:
                codes = upload_codes(strand_data, device)
            skey, sa_all = window_arrays_from_codes(codes, k, W, ws)
            key, sa = skey[a:b].clone(), sa_all[a:b].clone()
            del skey, sa_all
        return cls(key=key, sa=sa, W=W, Wl=Wl, r=r, D=D, k=k, first_len=n1,
                   win_start=ws, win_end=we, reverse=reverse,
                   complement=complement)
