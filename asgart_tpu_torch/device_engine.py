"""The fused whole-genome engine on one device.

Counterpart of ``FusedEngine`` (asgart_tpu/device_engine.py:2157) for the
whole-genome, one-device route (k = 2..30). Per chunk: KD ``scan_core`` on the
chunk's lane slice of the fused index, one device-to-host copy of its
exactly-sized outputs, then the native event chain with the arguments of
device_engine.py:1519-1525. The JAX engine's capacity buckets, overflow
retries, sliced and grouped dispatch and packed downloads are not needed:
KD sizes its outputs exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from asgart_tpu import native

from .fused_index import INDEX_CACHE, FusedIndex, IndexCache
from .host_helpers import _merge_shard_events
from .kernels import scan_core


def chunk_specs(chunks, settings) -> tuple:
    """((chunk_start, chunk_len, n_lanes), ...) of the chunks that probe at
    all — the geometry of ``_chunk_geometry`` (device_engine.py:1224) and
    ``FusedEngine._specs_for`` (:2185)."""
    k = settings.probe_size
    step = k // 2
    specs = []
    for start, length in chunks:
        bound = length - k - step
        if length < settings.min_duplication_length or bound <= 0:
            continue
        specs.append((int(start), int(length), (bound + step - 1) // step))
    return tuple(specs)


class FusedEngine:
    """Whole-genome engine over a :class:`FusedIndex` on ``device``.

    The index is built (or served from ``cache``) for the whole chunk set
    at the first :meth:`run_chunks`; ``index`` supplies a prebuilt one
    (e.g. from :mod:`asgart_tpu_torch.convert`)."""

    def __init__(self, strand, settings, device: torch.device,
                 cache: IndexCache | None = None,
                 index: FusedIndex | None = None):
        self.strand = strand
        self.settings = settings
        self.device = device
        self.cache = INDEX_CACHE if cache is None else cache
        self.index = index

    def ensure_index(self, chunks) -> FusedIndex:
        if self.index is None:
            s = self.settings
            self.index = self.cache.get_or_build(
                self.strand.data, s.probe_size, chunk_specs(chunks, s),
                s.reverse, s.complement, self.device)
        return self.index

    def run_chunks(self, chunks) -> list:
        """Raw families (native-engine format, chunk-relative left
        coordinates) for each chunk, in order."""
        idx = self.ensure_index(chunks)
        lanes = {(cs, cl): slice(idx.offs[(cs, cl)][0],
                                 idx.offs[(cs, cl)][0] + nc)
                 for (cs, cl, nc) in idx.specs}
        return [self._run_chunk(idx, (int(c[0]), int(c[1])), lanes)
                for c in chunks]

    def _run_chunk(self, idx: FusedIndex, chunk, lane_slices):
        lanes = lane_slices.get(chunk)
        if lanes is None:  # too short to probe
            return []
        s = self.settings
        k = s.probe_size
        res = scan_core(idx.lane_lo[lanes], idx.lane_hi[lanes],
                        idx.lane_mask[lanes], idx.sa, chunk[0], chunk[1],
                        s.max_cardinality, 0, k, s.reverse)
        ev, m, z_trail = _merge_shard_events([res.to_host()])
        if ev is None:
            return []
        m_offsets = np.zeros(ev.shape[1] + 1, dtype=np.int64)
        np.cumsum(ev[2], out=m_offsets[1:])
        return native.chain_events(
            ev[0], ev[1], m_offsets, m, z_trail=z_trail,
            probe_size=k, step_size=k // 2,
            max_gap_size=s.max_gap_size,
            min_duplication_length=s.min_duplication_length,
            max_cardinality=s.max_cardinality)
