"""The fused-probe whole-genome index on one device.

Counterpart of ``FusedIndex`` / ``FusedIndex.build`` and ``fused_fits``
(asgart_tpu/device_index.py:1571-1787) for the whole-genome, k <= 20 case,
plus a one-entry device index cache (the counterpart of ``cached_build``,
device_index.py:1064).

The direct text's W = n1 key rows and every chunk's probe-lane rows are
sorted together; equal-key runs then give each probe lane its window
[lane_lo, lane_hi) of direct suffixes, and tie resolution turns the
k-mer order into the suffix order. Build steps and their kernels:

  upload codes (codes.py) -> KA pack_keys -> torch.sort(stable=True)
  -> KB group_bounds -> KC invert_fused -> ties.resolve_ties
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .codes import upload_codes
from .host_helpers import _bucket, _strand_fingerprint
from .kernels import group_bounds, invert_fused, pack_keys
from .ties import resolve_ties

MAX_K = 20  # two 30-bit symbol planes in one int64 key

# Device bytes per fused row (W + probe lanes) at the build's peak: the
# stable sort holds the int64 key, its sorted copy, the int64 row indices
# and the sort's scratch, next to codes and lane arrays. Measured
# 48.34 B/row at 141.7 M rows on an H100 80GB (chip_smoke.py prints it);
# 50 leaves a margin.
PEAK_BYTES_PER_ROW = 50


def fused_layout(n1: int, specs) -> tuple[int, int, list[int]]:
    """(W, total, lane_off): W = n1 direct rows, then ``total`` probe-lane
    rows — the chunks' lanes back-to-back (chunk c from lane_off[c]) and
    the JAX build's slack (device_index.py:1662), so both builds sort the
    same rows; the pad rows sort last."""
    tail_pad = max((_bucket(nc) - nc for (_, _, nc) in specs),
                   default=1 << 16) + 8
    lane_off = [0]
    for (_, _, nc) in specs:
        lane_off.append(lane_off[-1] + nc)
    return n1, lane_off[-1] + tail_pad, lane_off


def fused_fits(n1: int, k: int, device: torch.device,
               reclaimable: int = 0) -> bool:
    """Whether the fused build of an ``n1``-byte strand fits ``device``:
    int32 row addressing, and on a GPU the projected peak within the free
    memory ``torch.cuda.mem_get_info`` reports, plus the blocks PyTorch's
    allocator holds unused, plus ``reclaimable`` bytes (a cached index
    that a miss would evict)."""
    M = n1 + n1 // max(1, k // 2) + (1 << 21)  # device_index.fused_fits
    if M >= (1 << 31):
        return False
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return M * PEAK_BYTES_PER_ROW <= free + reclaimable


@dataclass
class FusedIndex:
    """Device-resident fused index: the final suffix order over the
    direct text with the probe rows interleaved, and the per-lane
    windows of a fixed chunk set."""

    sa: torch.Tensor         # int32 [W + total]; direct slots hold text
    #                          positions, probe slots W + lane (never read)
    lane_lo: torch.Tensor    # int32 [total] window starts, lane order
    lane_hi: torch.Tensor    # int32 [total] window ends
    lane_mask: torch.Tensor  # bool [total] live-probe mask
    specs: tuple             # ((chunk_start, chunk_len, n_lanes), ...)
    offs: dict               # (chunk_start, chunk_len) -> (lane_offset,
    #                          raw match total)
    k: int
    n: int                   # doubled text length (probe addressing)
    first_len: int           # genome + '$' length
    reverse: bool
    complement: bool

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.sa, self.lane_lo, self.lane_hi,
                             self.lane_mask))

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int, specs: tuple,
              reverse: bool, complement: bool,
              device: torch.device) -> "FusedIndex":
        if not 2 <= k <= MAX_K:
            raise ValueError(f"fused index supports probe_size 2..{MAX_K}")
        n1 = int(len(strand_data))
        n = 2 * n1 - 1 if (reverse or complement) else n1
        W, total, lane_off = fused_layout(n1, specs)
        M = W + total
        if n >= (1 << 31) or M >= (1 << 31):
            raise ValueError("genome too large for int32 addressing")

        codes = upload_codes(strand_data, device)
        key, lane_mask = pack_keys(codes, specs, k, reverse, complement, W,
                                   total)
        del codes
        skey, order = torch.sort(key, stable=True)
        del key
        sa = order.to(torch.int32)
        del order
        run_lo, run_hi, tied = group_bounds(skey, sa, W)
        del skey
        rank, lane_lo, lane_hi, totals = invert_fused(
            sa, run_lo, run_hi, lane_mask, W, lane_off)
        del run_lo, run_hi
        sa = resolve_ties(sa, rank, tied, M, k)
        offs = {(cs, cl): (off, int(t)) for (cs, cl, _), off, t in
                zip(specs, lane_off, totals.tolist())}
        return cls(sa=sa, lane_lo=lane_lo, lane_hi=lane_hi,
                   lane_mask=lane_mask, specs=tuple(specs), offs=offs, k=k,
                   n=n, first_len=n1, reverse=reverse,
                   complement=complement)


def device_index_cache_enabled() -> bool:
    """``ASGART_DEVICE_INDEX_CACHE=0`` disables the cache, as in the JAX
    package (device_index.py:947)."""
    return os.environ.get("ASGART_DEVICE_INDEX_CACHE", "1") != "0"


class IndexCache:
    """One-entry cache of the last built index, keyed by the strand's
    content fingerprint and every build argument: a rescan of the same
    genome and chunks skips the build. A miss evicts the entry before
    building, so its memory is free for the build's peak."""

    def __init__(self):
        self._key = None
        self._index = None

    def reclaimable_bytes(self) -> int:
        return self._index.nbytes() if self._index is not None else 0

    def clear(self) -> None:
        self._key = self._index = None

    def get_or_build(self, strand_data, k, specs, reverse, complement,
                     device) -> FusedIndex:
        if not device_index_cache_enabled():
            self.clear()
            return FusedIndex.build(strand_data, k, specs, reverse,
                                    complement, device)
        key = (_strand_fingerprint(strand_data), k, tuple(specs),
               bool(reverse), bool(complement), str(device))
        if key != self._key:
            self.clear()
            self._index = FusedIndex.build(strand_data, k, specs, reverse,
                                           complement, device)
            self._key = key
        return self._index


# the process-wide default cache (a long-lived service rescanning a
# genome hits it across `search_duplications` calls)
INDEX_CACHE = IndexCache()
