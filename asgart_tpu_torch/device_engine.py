"""The device engines on one device: the fused engine (the whole genome or
one trim window) and the merge-join window engine.

Counterpart of ``FusedEngine`` (asgart_tpu/device_engine.py:2157) for the
one-device route (k = 2..30), with its ``trim`` window build, and of
``DeviceWindowEngine`` (:1749) for trim windows at k = 2..20. Per chunk: KD
``scan_core`` on the chunk's lane slice, one device-to-host copy of its
exactly-sized outputs, then the native event chain with the arguments of
device_engine.py:1519-1525. The JAX engines' capacity buckets, overflow
retries, sliced and grouped dispatch and packed downloads are not needed:
KD sizes its outputs exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .codes import upload_codes
from .fused_index import INDEX_CACHE, FusedIndex, IndexCache
from .host_helpers import _merge_shard_events
from .kernels import mj_ranges, pack_keys, scan_core
from .window_index import DeviceWindowIndex, ProbeKeyCache, WindowRanges


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
    """Engine over a :class:`FusedIndex` on ``device``: of the whole genome,
    or of the trim window ``trim`` = (ws, we) probed by the whole genome.

    The index is built (or served from ``cache``; ``None`` builds without
    caching) for the whole chunk set at the first :meth:`run_chunks`;
    ``codes`` are the strand's codes already on ``device``; ``index``
    supplies a prebuilt index (e.g. from :mod:`asgart_tpu_torch.convert`)."""

    def __init__(self, strand, settings, device: torch.device,
                 cache: IndexCache | None = INDEX_CACHE,
                 index: FusedIndex | None = None, trim=None,
                 codes: torch.Tensor | None = None):
        self.strand = strand
        self.settings = settings
        self.device = device
        self.cache = cache
        self.index = index
        self.trim = None if trim is None else (int(trim[0]), int(trim[1]))
        self.codes = codes

    def ensure_index(self, chunks) -> FusedIndex:
        if self.index is None:
            s = self.settings
            args = (s.probe_size, chunk_specs(chunks, s), s.reverse,
                    s.complement)

            def build():
                return FusedIndex.build(self.strand.data, *args, self.device,
                                        self.trim, self.codes)

            self.index = build() if self.cache is None else \
                self.cache.get_or_build(
                    "fused", self.strand.data,
                    (*args, str(self.device), self.trim), build)
        return self.index

    def run_chunks(self, chunks) -> list:
        """Raw families (native-engine format, chunk-relative left
        coordinates) for each chunk, in order."""
        return chain_chunk_events(self.scan_chunks(chunks), self.settings)

    def scan_chunks(self, chunks) -> list:
        """The device phase: each chunk's merged events on the host, (ev
        int32 [3, n], m int32, z_trail) or None (no event), in order."""
        idx = self.ensure_index(chunks)
        return scan_lanes(self.settings, idx, idx.sa, chunks)


class DeviceWindowEngine:
    """Merge-join engine over a :class:`DeviceWindowIndex` of the trim
    window ``trim`` = (ws, we) on ``device``, probed by the whole genome
    (k = 2..20; the JAX package's ``DeviceWindowEngine``).

    Stage 1 runs one batched pass for all chunks: KA's probe-only mode
    packs every chunk's probe keys (or ``probe_cache`` serves them: they
    do not depend on the window), then KH ``mj_ranges`` joins them to the
    sorted window keys. The result is kept with the index, so a rescan of
    the same chunks from ``cache`` skips the build, the pack and the join.
    Then KD per chunk, as in :class:`FusedEngine`. ``codes``: the strand's
    codes already on ``device`` (uploaded on first need otherwise);
    ``index`` supplies a prebuilt index (e.g. from
    :mod:`asgart_tpu_torch.convert`)."""

    def __init__(self, strand, settings, device: torch.device, trim,
                 cache: IndexCache | None = INDEX_CACHE,
                 index: DeviceWindowIndex | None = None,
                 codes: torch.Tensor | None = None,
                 probe_cache: ProbeKeyCache | None = None):
        self.strand = strand
        self.settings = settings
        self.device = device
        self.trim = (int(trim[0]), int(trim[1]))
        self.cache = cache
        self.index = index
        self.codes = codes
        self.probe_cache = probe_cache

    def _codes(self) -> torch.Tensor:
        if self.codes is None:
            self.codes = upload_codes(self.strand.data, self.device)
        return self.codes

    def ensure_index(self, chunks=None) -> DeviceWindowIndex:
        if self.index is None:
            s = self.settings
            args = (s.probe_size, self.trim, s.reverse, s.complement)

            def build():
                return DeviceWindowIndex.build(self.strand.data, *args,
                                               self.device, self._codes())

            self.index = build() if self.cache is None else \
                self.cache.get_or_build("window", self.strand.data,
                                        (*args, str(self.device)), build)
        return self.index

    def stage1(self, chunks) -> WindowRanges:
        """Every chunk's probe lanes with their windows in the sorted
        window (the JAX ``_batch_stage1``, device_engine.py:1872, in one
        pass whatever the chunk count)."""
        idx = self.ensure_index()
        s = self.settings
        specs = chunk_specs(chunks, s)
        if idx.stage1 is not None and idx.stage1.specs == specs:
            return idx.stage1
        lane_off = [0]
        for (_, _, nc) in specs:
            lane_off.append(lane_off[-1] + nc)

        def pack():
            (pkey,), mask = pack_keys(self._codes(), specs, s.probe_size,
                                      s.reverse, s.complement, 0,
                                      lane_off[-1])
            return pkey, mask

        pkey, mask = (pack() if self.probe_cache is None else
                      self.probe_cache.get_or_pack(
                          (s.probe_size, s.reverse, s.complement, specs,
                           str(self.device)), pack))
        lane_lo, lane_hi, totals = mj_ranges(idx.key, pkey, mask, lane_off)
        offs = {(cs, cl): (off, int(t)) for (cs, cl, _), off, t in
                zip(specs, lane_off, totals.tolist())}
        idx.stage1 = WindowRanges(lane_lo=lane_lo, lane_hi=lane_hi,
                                  lane_mask=mask, specs=specs, offs=offs)
        return idx.stage1

    def run_chunks(self, chunks) -> list:
        """Raw families (native-engine format, chunk-relative left
        coordinates) for each chunk, in order."""
        return chain_chunk_events(self.scan_chunks(chunks), self.settings)

    def scan_chunks(self, chunks) -> list:
        """The device phase, as :meth:`FusedEngine.scan_chunks`."""
        ranges = self.stage1(chunks)
        return scan_lanes(self.settings, ranges, self.index.sa, chunks)


def scan_lanes(settings, lanes, sa: torch.Tensor, chunks) -> list:
    """KD over each chunk's lane slice of ``lanes`` (a :class:`FusedIndex`
    or a :class:`WindowRanges`: lane_lo, lane_hi, lane_mask, specs, offs)
    against the suffix order ``sa``, then one device-to-host copy per
    chunk: (ev int32 [3, n], m int32, z_trail) or None (too short to
    probe, or no event), in chunk order."""
    s = settings
    n_lanes = {(cs, cl): nc for (cs, cl, nc) in lanes.specs}
    out = []
    for c in chunks:
        chunk = (int(c[0]), int(c[1]))
        if chunk not in n_lanes:  # too short to probe
            out.append(None)
            continue
        off = lanes.offs[chunk][0]
        sl = slice(off, off + n_lanes[chunk])
        res = scan_core(lanes.lane_lo[sl], lanes.lane_hi[sl],
                        lanes.lane_mask[sl], sa, chunk[0], chunk[1],
                        s.max_cardinality, 0, s.probe_size, s.reverse)
        ev, m, z_trail = _merge_shard_events([res.to_host()])
        out.append(None if ev is None else (ev, m, z_trail))
    return out


def chain_chunk_events(events, settings) -> list:
    """The host phase: raw families of each chunk's events (the output of
    :meth:`FusedEngine.scan_chunks`); touches no device memory, so a
    sharded run's tail thread runs it without holding the index."""
    k = settings.probe_size
    out = []
    for e in events:
        if e is None:
            out.append([])
            continue
        ev, m, z_trail = e
        m_offsets = np.zeros(ev.shape[1] + 1, dtype=np.int64)
        np.cumsum(ev[2], out=m_offsets[1:])
        out.append(native.chain_events(
            ev[0], ev[1], m_offsets, m, z_trail=z_trail,
            probe_size=k, step_size=k // 2,
            max_gap_size=settings.max_gap_size,
            min_duplication_length=settings.min_duplication_length,
            max_cardinality=settings.max_cardinality))
    return out
