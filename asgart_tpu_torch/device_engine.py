"""The device engines: the fused engine (the whole genome or one trim
window), the table engine (the whole genome, chunk by chunk), the
merge-join window engine and its rank-sharded and mesh forms.

Counterpart of ``FusedEngine`` (asgart_tpu/device_engine.py:2157) for the
one-device route (k = 2..30), with its ``trim`` window build, and of both
merge-join window engines at k = 2..20: ``DeviceWindowEngine`` (:1749) and
``BigWindowEngine`` (:2380), which the JAX package keeps apart because its
window index holds genome positions in int32. The port's window index
always keeps window positions, so one engine serves every genome size.
The table engine is the counterpart of ``DeviceEngine`` (:1180) on one
device: its index (table_index.py) does not depend on the chunk set, so
``--checkpoint`` runs scan and journal one chunk at a time; KM
``table_ranges`` reads each probe lane's window from the position tables
(the front of ``_scan_chunk``, :202), for all of a call's chunks in one
launch.
Per chunk: KD ``scan_core`` on the chunk's lane slice, one device-to-host
copy of its exactly-sized outputs, then the native event chain with the
arguments of device_engine.py:1519-1525 (the merge-join engine's matches
first rebased to genome positions in int64, :1488-1490). With
``ASGART_DEVICE_CHAIN`` set (read at each chain, as ``_chain_merged``
reads it, :1495) the events stay on the card and KN ``chain_bursts``
chains them right after the chunk's scan, adding the window start to the
matches in int64; only the families come back (chain.py).

Sliced dispatch, on every engine (the JAX ``_dispatch_chunk_sliced``,
:1316, and ``_sliced_windows``, :1394): a chunk whose exact raw total (the
sum of its lanes' window sizes, which every engine already has) reaches
``ASGART_DEVICE_SLICE_LANES`` (default 2^26) is scanned as consecutive
probe slices, so the card holds one slice's KD transient and outputs at a
time and not the whole chunk's. KO ``granule_totals`` sums the windows
per granule of 4096 lanes, the host packs granules into slices (a copy of
``_plan_slices``), and each slice is a view of the chunk's lanes scanned
by KD with j0 at its lane offset. On the host chain each slice's outputs
are copied to the host and let go before the next slice is scanned, and
the parts merge with the aging carry (``_merge_shard_events``, as
``_collect_chunk`` merges them, :1430); on the device chain the slices
stay on the card and KP ``gather_flat`` merges them into one buffer in
KD's layout for KN (the JAX ``_gather_flat``, :1112). Not carried over:
the JAX engines' capacity buckets and overflow retries (KD sizes its
outputs exactly, so neither the slices' ``ev_scale`` retries nor the
``_CAP_CACHE`` marker), grouped dispatch and packed downloads;
``_slice_caps``' refusal of a slice past ``SLICE_HARD_CAP``, which guards
the JAX gather of a slice's raw windows (KD never holds them); the slice
planner's B_GRAN lane cap and ``_fixed_slice_width``'s aligned power-of-two
slices, which exist for the JAX table padding and static shapes (any
partition into consecutive slices merges to the same stream).

On a process group of ranks (``distributed.py``; the JAX mesh engines,
K17): the table engine's probe-axis scan, each rank scanning its own
lanes of every chunk (``_sharded_scan`` and ``_sharded_scan_group``, :987
and :1019; ``_sharded_sliced_scan``, :1054, as each rank's own sliced
scan) before every rank merges all ranks' streams;
:class:`ShardedWindowEngine` (:3245), one trim window's index cut into
the ranks' shards, whose stage 1 and match gather are summed over the
ranks (``_sharded_window_ranges_fn`` and ``_sharded_window_core_fn``,
:3134 and :3169; KT ``gather_owned``); and :class:`MeshWindowEngine`
(:2903), ``--shards`` windows on a windows x probes layout of the ranks,
each rank one window's index and one probe slice of every chunk
(``_mesh_window_ranges``, ``_mesh_ranges_batch``,
``_mesh_window_core_off`` and ``_mesh_window_core``, :2788-2877).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import distributed, native
from .chain import chain_events_tensors, config_for, events_from_flat
from .codes import upload_codes
from .fused_index import (INDEX_CACHE, FusedIndex, IndexCache, free_bytes,
                          mj_fits, probe_span)
from .host_helpers import (SLICE_GRAN, _bucket, _merge_shard_events,
                           _plan_slices, _slice_budget)
from .kernels import (gather_flat, gather_owned, granule_totals, mj_ranges,
                      pack_keys, scan_core, table_ranges)
from .kernels.merge_join import read_totals, totals_with_flag
from .kernels.scan_core import ScanResult, fused_bases
from .kernels.sharded import csr_offsets
from .table_index import DeviceIndex
from .window_index import (DeviceWindowIndex, ProbeKeyCache,
                           ShardedWindowIndex, WindowRanges)


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
    supplies a prebuilt index (e.g. from :mod:`asgart_tpu_torch.convert`;
    a window's must be of the same ``trim``).

    A window's suffix order keeps window positions (fused_index.py), so
    KD scans it with :func:`rebased_bases` and the window start
    ``m_offset`` is added to the matches in int64, on the host
    (:func:`chain_chunk_events`) or by KN (:func:`chain_on_device`), as on
    the merge-join engine. KD reads no probe slot (W + lane): a lane's
    window [lane_lo, lane_hi) holds the direct rows of its key's run (KB
    gives a probe row the run's direct rows, which sort before the probe
    rows of the same key; tie resolution reorders direct rows among
    themselves), and every direct slot is a window position in [0, W). So
    the rebased constants, clamped to [-(chunk_len + 2), W + 2], keep
    every comparison's outcome, as they do for the merge-join index."""

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
        # added to the matches: window positions to genome positions
        self.m_offset = 0 if self.trim is None else self.trim[0]
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
        return families(self.scan_chunks(chunks), self.settings,
                        self.m_offset)

    def scan_chunks(self, chunks) -> list:
        """The device phase (:func:`device_phase`), in chunk order."""
        return device_phase(self, chunks)

    def scan_results(self, chunks):
        """KD's result for each chunk, in order (:func:`scan_lanes`)."""
        idx = self.ensure_index(chunks)
        if idx.trim != self.trim:
            raise ValueError(f"FusedEngine: an index of the window "
                             f"{idx.trim} for the window {self.trim}")
        if self.trim is None:
            return scan_lanes(self.settings, idx, idx.sa, chunks,
                              fused_bases)
        ws, we = self.trim
        return scan_lanes(self.settings, idx, idx.sa, chunks,
                          lambda cs, cl: rebased_bases(cs, cl, ws,
                                                       we - ws + 1))


class TableEngine:
    """Engine over a :class:`~asgart_tpu_torch.table_index.DeviceIndex` of
    the whole genome on ``device`` (the JAX ``DeviceEngine`` on one
    device, without its capacity buckets, pre-passes and packed downloads:
    KD sizes its outputs exactly; repeat-heavy chunks are sliced as on
    every engine, :func:`scan_lanes`). The index is built (or
    served from ``cache``) at the first scan, whatever chunks it is asked
    for; ``index`` supplies a prebuilt one (e.g. from
    :mod:`asgart_tpu_torch.convert`)."""

    m_offset = 0  # added to the matches (genome positions)

    def __init__(self, strand, settings, device: torch.device,
                 cache: IndexCache | None = INDEX_CACHE,
                 index: DeviceIndex | None = None):
        self.strand = strand
        self.settings = settings
        self.device = device
        self.cache = cache
        self.index = index

    def ensure_index(self, chunks=None) -> DeviceIndex:
        if self.index is None:
            s = self.settings
            args = (s.probe_size, s.reverse, s.complement)

            def build():
                return DeviceIndex.build(self.strand.data, *args,
                                         self.device)

            self.index = build() if self.cache is None else \
                self.cache.get_or_build(
                    "table", self.strand.data, (*args, str(self.device)),
                    build)
        return self.index

    def ranges(self, chunks) -> WindowRanges:
        """Every chunk's probe lanes with their windows, read from the
        tables by KM (one launch for all ``chunks``)."""
        idx = self.ensure_index()
        s = self.settings
        specs = chunk_specs(chunks, s)
        lane_lo, lane_hi, mask, totals, lane_off = table_ranges(
            idx.pos_lo, idx.pos_hi, specs, idx.first_len, s.probe_size,
            s.reverse, s.complement)
        offs = {(cs, cl): (off, int(t)) for (cs, cl, _), off, t in
                zip(specs, lane_off, totals.tolist())}
        return WindowRanges(lane_lo=lane_lo, lane_hi=lane_hi,
                            lane_mask=mask, specs=specs, offs=offs)

    def run_chunks(self, chunks) -> list:
        """Raw families (native-engine format, chunk-relative left
        coordinates) for each chunk, in order."""
        return families(self.scan_chunks(chunks), self.settings,
                        self.m_offset)

    def run_chunk(self, chunk) -> list:
        """Raw families of one chunk (a journaled run's unit of work)."""
        return self.run_chunks([chunk])[0]

    def scan_chunks(self, chunks) -> list:
        """The device phase (:func:`device_phase`), in chunk order."""
        return device_phase(self, chunks)

    def scan_results(self, chunks):
        """KD's result for each chunk, in order (:func:`scan_lanes`). Under
        a process group of D > 1 ranks, the probe-axis scan (the JAX
        ``DeviceEngine`` on a mesh, device_engine.py:1198-1240 and
        ``_sharded_scan``, :987): every rank holds the whole table, scans
        its own lanes of each chunk (:func:`probe_lanes`; a repeat-heavy
        rank's lanes sliced as on one device), and every rank merges all
        ranks' results (:func:`gather_ranks`)."""
        ranges = self.ranges(chunks)
        D = distributed.world()
        if D == 1:
            return scan_lanes(self.settings, ranges, self.index.sa, chunks,
                              fused_bases)
        r = distributed.rank()
        return gather_ranks(scan_lanes(
            self.settings, ranges, self.index.sa, chunks, fused_bases,
            part=lambda nc: probe_lanes(nc, r, D)))


def probe_lanes(n_lanes: int, r: int, D: int) -> tuple[int, int]:
    """The lanes [a, b) of a chunk's ``n_lanes`` that rank ``r`` of ``D``
    scans: [r·b_local, (r + 1)·b_local) within the chunk, with
    ``_chunk_geometry``'s b_local (device_engine.py:1224-1239: the bucket
    of the lane count rounded up to a multiple of D, over D). The last
    ranks may get no lane."""
    b_pad = _bucket(n_lanes)
    b_pad += -b_pad % D
    b_local = b_pad // D
    return min(n_lanes, r * b_local), min(n_lanes, (r + 1) * b_local)


def gather_cells(results):
    """Each chunk's result of :func:`scan_lanes` over this rank's lanes
    (None, a ``ScanResult``, or a :class:`Sliced`, merged first), shared
    with every rank (``distributed.all_gather_var``): None (too short to
    probe, on every rank alike), or every rank's ``ScanResult`` in rank
    order."""
    for res in results:
        if res is None:
            yield None
            continue
        if isinstance(res, Sliced):
            res = merge_slices(list(res))
        flats = distributed.all_gather_var(res.flat)
        meta = distributed.all_gather_var(torch.tensor(
            [res.n_events, res.total_kept], dtype=torch.int64,
            device=res.flat.device))
        del res
        yield [ScanResult(f, int(m[0]), int(m[1]))
               for f, m in zip(flats, meta)]


def gather_ranks(results):
    """:func:`gather_cells`, each chunk's results merged in rank order by
    :func:`merge_slices`: the ranks' lanes are consecutive probe slices,
    so the merge is the JAX ``_merge_shard_events`` (:1082) over the
    mesh's shards. Every rank ends with the whole chunk's result."""
    for cells in gather_cells(results):
        yield None if cells is None else merge_slices(cells)


class DeviceWindowEngine:
    """Merge-join engine over a :class:`DeviceWindowIndex` of the trim
    window ``trim`` = (ws, we) on ``device``, probed by the whole genome
    (k = 2..20; the JAX package's ``DeviceWindowEngine`` and
    ``BigWindowEngine``).

    Stage 1 runs one batched pass for all chunks: KA's probe-only mode
    packs every chunk's probe keys (or ``probe_cache`` serves them: they
    do not depend on the window), reading the transformed probes from the
    strand's codes with 64-bit offsets, then KH ``mj_ranges`` joins them
    to the sorted window keys, searching from the index's key directory
    (``mj_directory``, built with the index). The result is kept with the
    index, so a rescan of the same chunks from ``cache`` skips the build,
    the pack and the join. Then KD per chunk over the window-relative
    suffix order, with the rebased filter constants of
    :func:`rebased_bases`; the window
    start ``m_offset`` is added to the matches in int64, on the host
    (:func:`chain_chunk_events`) or by KN (:func:`chain_on_device`).
    ``codes``: the strand's codes already on ``device`` (uploaded on first
    need otherwise); ``index`` supplies a prebuilt index (e.g. from
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
        self.m_offset = self.trim[0]  # added to the matches
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
                self.cache.get_or_build(
                    "window", self.strand.data,
                    (*args, str(self.device)), build)
        return self.index

    def stage1(self, chunks) -> WindowRanges:
        """Every chunk's probe lanes with their windows in the sorted
        window (the JAX ``_batch_stage1``, device_engine.py:1872, and
        ``BigWindowEngine``'s, :2533, in one pass whatever the chunk
        count)."""
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
        lane_lo, lane_hi, totals = self.join(idx.key, pkey, mask, lane_off,
                                             idx.directory)
        # the totals' one host read carries the directory's flag: keys out
        # of order raise here, before the ranges are used
        offs = {(cs, cl): (off, t) for (cs, cl, _), off, t in
                zip(specs, lane_off, read_totals(totals))}
        idx.stage1 = WindowRanges(lane_lo=lane_lo, lane_hi=lane_hi,
                                  lane_mask=mask, specs=specs, offs=offs)
        return idx.stage1

    @staticmethod
    def join(key, pkey, mask, lane_off, directory):
        """KH: (lane_lo, lane_hi, per-chunk totals and the directory's flag:
        :func:`totals_with_flag`) of the probe keys in the sorted window
        keys ``key``, searched from their ``directory``."""
        lane_lo, lane_hi, totals = mj_ranges(key, pkey, mask, lane_off,
                                             directory)
        return lane_lo, lane_hi, totals_with_flag(totals, directory)

    def run_chunks(self, chunks) -> list:
        """Raw families (native-engine format, chunk-relative left
        coordinates) for each chunk, in order."""
        return families(self.scan_chunks(chunks), self.settings,
                        self.m_offset)

    def run_chunk(self, chunk) -> list:
        """Raw families of one chunk (a journaled run's unit of work: its
        stage 1 packs and joins this chunk's probes alone)."""
        return self.run_chunks([chunk])[0]

    def scan_chunks(self, chunks) -> list:
        """The device phase (:func:`device_phase`), in chunk order."""
        return device_phase(self, chunks)

    def scan_results(self, chunks, part=None):
        """KD's result for each chunk, in order (:func:`scan_lanes`; ``part``
        as there)."""
        ranges = self.stage1(chunks)
        ws, W = self.trim[0], self.index.W
        return scan_lanes(self.settings, ranges, self.index.sa, chunks,
                          lambda cs, cl: rebased_bases(cs, cl, ws, W),
                          part=part)


class MeshWindowEngine(DeviceWindowEngine):
    """The windows x probes mesh engine (the JAX ``MeshWindowEngine``,
    asgart_tpu/device_engine.py:2903) on a process group: D ranks form S
    windows of P = D / S ranks each, and rank r is cell (w, p) = (r // P,
    r % P), as device r of the JAX (S, P) mesh (asgart_tpu/pipeline.py:
    414-415). ``r`` and ``D`` default to this process's rank and world;
    the tests pass them to compute any cell in one process.

    Each rank builds only window w's :class:`DeviceWindowIndex` (merge
    join, window positions; the JAX engine pads every window to a common
    width with INT32_MAX keys only to stack them on its mesh, :2952-2971,
    and those keys never match a probe). Stage 1 is
    :meth:`DeviceWindowEngine.stage1`: KA's probe-only pack and KH over
    every chunk's lanes in one pass, which is ``_mesh_ranges_batch``
    (:2817) and, for one live chunk, ``_mesh_window_ranges`` (:2788). Cell
    (w, p) owns lanes :func:`probe_lanes` (n, p, P) of a chunk of n lanes
    (the JAX ``_geometry``, :2976-2991, lane origin p·b_local), and KD
    scans them with :func:`rebased_bases` (``_mesh_window_core_off``,
    :2847, and ``_mesh_window_core``, :2877; KD sizes its outputs exactly,
    so there is no cap and no retry; a repeat-heavy cell's lanes are
    sliced as on one device). Per chunk one world-wide ``all_gather_var``
    shares every cell's result (:func:`gather_cells`); every rank merges
    each window's P cells in p order with the aging carry
    (:func:`merge_slices`, the JAX ``_chain_cells``, :3091-3115) and
    chains every window itself, so every rank holds the whole result."""

    def __init__(self, strand, settings, device: torch.device, windows,
                 r: int | None = None, D: int | None = None,
                 cache: IndexCache | None = None,
                 codes: torch.Tensor | None = None):
        self.windows = [(int(a), int(b)) for a, b in windows]
        r = distributed.rank() if r is None else r
        D = distributed.world() if D is None else D
        S = len(self.windows)
        if not 0 < S <= D or D % S or not 0 <= r < D:
            raise ValueError(f"rank {r} of {D} forms no cell of a mesh of "
                             f"{S} windows")
        n1 = int(len(strand.data))
        if probe_span(n1, settings.reverse or settings.complement) \
                >= 1 << 31:
            # as the JAX engine refuses it (:2934-2936)
            raise ValueError("genome too large for int32 probe addressing")
        self.S, self.P = S, D // S
        self.w, self.p = divmod(r, self.P)
        super().__init__(strand, settings, device, self.windows[self.w],
                         cache=cache, codes=codes)

    def part(self, n_lanes: int) -> tuple[int, int]:
        """This cell's lanes [a, b) of a chunk's ``n_lanes``."""
        return probe_lanes(n_lanes, self.p, self.P)

    def scan_windows(self, chunks) -> list:
        """The device phase of every window (:func:`device_phase`'s entries,
        each window's matches shifted by its start): [w][chunk]. Per chunk
        every cell's result (:meth:`scan_results` over :meth:`part`) is
        gathered, and each window's P cells are merged in p order."""
        finish = finisher(self.settings)
        S, P = self.S, self.P
        out = [[] for _ in self.windows]
        for cells in gather_cells(self.scan_results(chunks, part=self.part)):
            for w, (ws, _) in enumerate(self.windows):
                out[w].append(None if cells is None else finish(
                    cells[w] if P == 1 else
                    merge_slices(cells[w * P: (w + 1) * P]), ws))
            del cells
        return out


class ShardedWindowEngine(DeviceWindowEngine):
    """Rank-sharded merge-join engine over one trim window (k = 2..20): the
    JAX ``ShardedWindowEngine`` (asgart_tpu/device_engine.py:3245) on a
    process group, one rank a shard. Each rank holds a
    :class:`ShardedWindowIndex`, rows [r·Wl, (r + 1)·Wl) of the window's
    sorted keys and suffix order, built on its device (the whole window's
    merge-join build, then cut) or, with ``ASGART_RSH_HOST_BUILD=1`` or
    when the window's build does not fit (``mj_fits``; :3283-3292), by
    ``host_window_arrays`` on the host.

    Stage 1 (``_sharded_window_ranges_fn``, :3134): KA's probe-only pack
    of every chunk's probes, as on one device, then KH against the rank's
    keys and an ``all_reduce`` of lane_lo, lane_hi and the chunk totals.
    A shard's KH counts its own rows below and at each probe key, so the
    sum over the shards is the global equal range (the ``psum`` at
    :3156-3157).

    Stage 2 (``_sharded_window_core_fn``, :3169): per chunk, or per slice
    of a repeat-heavy chunk, KT ``gather_owned`` writes every masked
    lane's window into a flat CSR buffer, this rank's rows from its shard
    and 0 elsewhere; an ``all_reduce`` sums the ranks' buffers (the
    ``psum`` of ``sa_gather``, :3180-3188). Every row of [0, W) has one
    owner and no lane's window passes W (the shards hold no padded row;
    the JAX INT32_MAX padding keys, :3303-3313, never equal a probe), so
    the sum is each row's window position, exact without the JAX ``+1 /
    -1``. KD then scans lanes [off, off + count) over the buffer with
    :func:`rebased_bases`, the same filters on the same match values as
    the one-device engine. Every rank ends with the same results and
    chains them itself, as the JAX workers do (distributed.py:12-14).
    Without a process group the one rank holds the whole window."""

    def ensure_index(self, chunks=None) -> ShardedWindowIndex:
        if self.index is None:
            s = self.settings
            ws, we = self.trim
            env = os.environ.get("ASGART_RSH_HOST_BUILD")
            if env is not None:
                host_build = env == "1"
            else:  # the device build holds the whole window at once
                # (this rank's own choice: the build has no collective,
                # and both builds give the same shard)
                n1 = int(len(self.strand.data))
                host_build = not mj_fits(n1, we - ws + 1, s.probe_size,
                                         free_bytes(self.device),
                                         resident=n1)
            args = (s.probe_size, self.trim, s.reverse, s.complement,
                    self.device, distributed.rank(), distributed.world(),
                    host_build)

            def build():
                return ShardedWindowIndex.build(
                    self.strand.data, *args,
                    None if host_build else self._codes())

            self.index = build() if self.cache is None else \
                self.cache.get_or_build("sharded", self.strand.data,
                                        tuple(map(str, args)), build)
        return self.index

    @staticmethod
    def join(key, pkey, mask, lane_off, directory):
        """KH against this rank's keys (from their directory), summed over
        the ranks; the directories' flags too, so that keys out of order
        on any shard raise on every rank."""
        lane_lo, lane_hi, totals = mj_ranges(key, pkey, mask, lane_off,
                                             directory)
        return (distributed.psum(lane_lo), distributed.psum(lane_hi),
                distributed.psum(totals_with_flag(totals, directory)))

    def scan_results(self, chunks):
        """KD's result for each chunk, in order (:func:`scan_lanes` with
        :meth:`gather` as the suffix order)."""
        ranges = self.stage1(chunks)
        ws, W = self.trim[0], self.index.W
        return scan_lanes(self.settings, ranges, None, chunks,
                          lambda cs, cl: rebased_bases(cs, cl, ws, W),
                          gather=self.gather)

    def gather(self, lane_lo, lane_hi, lane_mask, total=None):
        """(lane_lo', lane_hi', src) for KD: the lanes' windows gathered
        into one flat buffer ``src`` (KT on this rank's rows, summed over
        the ranks), each lane's window [lane_lo', lane_hi') of it.
        ``total``, the masked lanes' summed window lengths where the
        caller holds it, spares a host read of the buffer's length."""
        off, total = csr_offsets(lane_lo, lane_hi, lane_mask, total)
        idx = self.index
        flat = distributed.psum(gather_owned(
            lane_lo, lane_hi, lane_mask, off, total, idx.sa, idx.row0))
        end = off + torch.where(lane_mask, lane_hi - lane_lo, 0)
        return off.to(torch.int32), end.to(torch.int32), flat


def rebased_bases(chunk_start: int, chunk_len: int, ws: int, W: int
                  ) -> tuple[int, int, int]:
    """KD's filter constants (self_base, dir_base, rev_t0) for a chunk over
    a window-relative suffix order (window start ``ws``, W rows): the
    fused ones minus ``ws``, clamped as ``BigWindowEngine._rebased``
    (asgart_tpu/device_engine.py:2632-2641) clamps them. Every window
    position m lies in [0, W) and every probe position i in (0,
    chunk_len), so clamping into [-(chunk_len + 2), W + 2] (rev_t0: [-2, W
    + chunk_len + 2]) keeps every comparison's outcome."""
    lo, hi = -(chunk_len + 2), W + 2
    return (min(max(-ws, lo), hi),
            min(max(chunk_start - ws, lo), hi),
            min(max(chunk_start + chunk_len - ws, -2), W + chunk_len + 2))


def device_chain() -> bool:
    """Whether ``ASGART_DEVICE_CHAIN`` asks for the chain on the device
    (read at each chain, as device_engine.py:1495 reads it)."""
    return bool(os.environ.get("ASGART_DEVICE_CHAIN"))


def finisher(settings):
    """``finish(res, m_offset)``: a chunk's entry of :func:`device_phase`
    from its KD result ``res``."""
    if device_chain():
        return lambda res, m_offset: chain_on_device(res, settings,
                                                     m_offset)
    return lambda res, m_offset: host_events(res)


def device_phase(eng, chunks) -> list:
    """The device phase of the engine ``eng`` over ``chunks``, one entry a
    chunk, in order, for :func:`families`: with :func:`device_chain`, the
    chunk's raw families, its events chained by KN on the device right
    after its scan (:func:`chain_on_device`), so one chunk's events are on
    the card at a time; else its merged events on the host, (ev int32 [3,
    n], m int32, z_trail) or None (no event), for the host chain."""
    finish = finisher(eng.settings)
    out = []
    for res in eng.scan_results(chunks):
        out.append(finish(res, eng.m_offset))
        del res  # let go before the next chunk's scan
    return out


def families(results, settings, m_offset: int = 0) -> list:
    """Raw families of each chunk of :func:`device_phase`'s ``results``: a
    chunk chained on the device as it is, the others through the host
    event chain (:func:`chain_chunk_events`). Touches no device memory, so
    a sharded run's tail thread runs it without holding the index."""
    return [r if isinstance(r, list) else
            chain_chunk_events([r], settings, m_offset)[0] for r in results]


class Sliced:
    """A chunk scanned as the probe slices of ``plan`` [(lane0, n_lanes,
    raw total)]: iterating it runs ``scan(lane0, n_lanes)`` (KD on the
    slice's view of the chunk's lanes) for one slice at a time, so a
    consumer that lets go of each ``ScanResult`` before asking for the
    next holds one slice's outputs."""

    def __init__(self, scan, plan: list):
        self.scan = scan
        self.plan = plan

    def __iter__(self):
        for lane0, n, _ in self.plan:
            yield self.scan(lane0, n)


def slice_plan(lane_lo: torch.Tensor, lane_hi: torch.Tensor,
               lane_mask: torch.Tensor, budget: int) -> list:
    """The probe slices [(lane0, n_lanes, raw total)] of one chunk's lanes:
    KO's exact granule totals packed by ``_plan_slices``, the last slice
    cut at the chunk's last lane."""
    n = lane_lo.numel()
    gt = granule_totals(lane_lo, lane_hi, lane_mask, SLICE_GRAN).tolist()
    return [(lane0, min(nl, n - lane0), t) for lane0, nl, t in
            _plan_slices(gt, SLICE_GRAN, budget)]


def scan_lanes(settings, lanes, sa: torch.Tensor | None, chunks, bases,
               gather=None, part=None):
    """KD over each chunk's lane slice of ``lanes`` (a :class:`FusedIndex`
    or a :class:`WindowRanges`: lane_lo, lane_hi, lane_mask, specs, offs)
    against the suffix order ``sa``, with the filter constants
    ``bases(chunk_start, chunk_len)``: yields, in chunk order and each
    before the next chunk's scan, None (too short to probe), the chunk's
    ``ScanResult``, or a :class:`Sliced` when the chunk's exact raw total
    reaches the slice budget (``ASGART_DEVICE_SLICE_LANES``, read at each
    call); ``scan_lanes.sliced`` counts those chunks. ``gather(lane_lo,
    lane_hi, lane_mask, total)``, when given, returns what KD reads in
    place of the lanes and ``sa`` (the rank-sharded engine's gathered
    windows; ``total`` is the lanes' exact raw total for a whole chunk,
    None for a slice);
    ``part(n_lanes)`` = (a, b) restricts each chunk to its lanes [a, b)
    (a probe-axis rank's), whose raw total then decides the slicing.

    The JAX engines slice when the capacity bucket of the total passes the
    budget; past B_GRAN the buckets are powers of two, so at the default
    budget (2^26) that is this rule. The JAX table engine adds a 0.1%
    margin to its float32 estimate (device_engine.py:1575-1576); the
    totals here are exact, so no margin is added."""
    s = settings
    budget = _slice_budget()
    n_lanes = {(cs, cl): nc for (cs, cl, nc) in lanes.specs}
    for c in chunks:
        chunk = (int(c[0]), int(c[1]))
        if chunk not in n_lanes:  # too short to probe
            yield None
            continue
        off, total = lanes.offs[chunk]
        a, b = (0, n_lanes[chunk]) if part is None else \
            part(n_lanes[chunk])
        nc = b - a
        lo, hi, mask = (t[off + a: off + b] for t in
                        (lanes.lane_lo, lanes.lane_hi, lanes.lane_mask))
        if part is not None:
            total = int(torch.where(mask, hi - lo, 0).sum())
        consts = bases(*chunk)

        def scan(lane0, n, total=None, lo=lo, hi=hi, mask=mask,
                 consts=consts, a=a):
            sl = (lo[lane0: lane0 + n], hi[lane0: lane0 + n],
                  mask[lane0: lane0 + n])
            lo_s, hi_s, src = (*sl[:2], sa) if gather is None else \
                gather(*sl, total)
            # j0: the slice's lane offset within the chunk
            return scan_core(lo_s, hi_s, sl[2], src, *consts,
                             s.max_cardinality, a + lane0, s.probe_size,
                             s.reverse)

        if total < budget:  # the whole chunk: its exact total is known
            yield scan(0, nc, total)
            continue
        scan_lanes.sliced += 1
        yield Sliced(scan, slice_plan(lo, hi, mask, budget))


scan_lanes.sliced = 0


def host_events(res):
    """Device-to-host copies of a chunk's KD result ``res`` (a
    ``ScanResult``, or a :class:`Sliced` whose slices are each copied and
    let go before the next slice's scan), merged with the aging carry as
    the JAX ``_collect_chunk`` merges its parts: (ev int32 [3, n], m
    int32, z_trail), or None (too short to probe, or no event)."""
    if res is None:
        return None
    parts = []
    for part in (res if isinstance(res, Sliced) else (res,)):
        parts.append(part.to_host())
        del part  # freed before the next slice's scan
    ev, m, z_trail = _merge_shard_events(parts)
    return None if ev is None else (ev, m, z_trail)


def merged_index(parts) -> torch.Tensor:
    """int64 [3 E + K + 1], on the parts' device: for each entry of the
    merged buffer of the KD results ``parts`` (E events and K kept matches
    in all, in ``ScanResult.flat``'s layout [ev_i | ev_z | ev_kept | m |
    z_trail]), its index in the concatenation of the parts' buffers; the
    last entry takes the last part's z_trail. Built on the card as an
    ``arange`` shifted in place run by run (4 S + 1 contiguous runs, each
    one offset), so nothing but the result is allocated."""
    dev = parts[0].flat.device
    E = sum(p.n_events for p in parts)
    K = sum(p.total_kept for p in parts)
    base = [0]
    for p in parts:
        base.append(base[-1] + p.flat.numel())
    runs = []  # (length, first source index), in output order
    for r in range(3):
        runs += [(p.n_events, b + r * p.n_events)
                 for p, b in zip(parts, base)]
    runs += [(p.total_kept, b + 3 * p.n_events) for p, b in zip(parts, base)]
    runs.append((1, base[-1] - 1))
    idx = torch.arange(3 * E + K + 1, dtype=torch.int64, device=dev)
    t0 = 0
    for n, src in runs:
        if n and src != t0:
            idx[t0: t0 + n] += src - t0
        t0 += n
    return idx


def merge_slices(parts) -> ScanResult:
    """One ``ScanResult`` of a sliced chunk's KD results ``parts``, on
    their device: KP gathers the parts' events and matches into one
    buffer (:func:`merged_index`), then one op on S + 1 values adds the
    aging carry as ``_merge_shard_events`` does: to each part's first
    event the quiet probes trailing the part before it (and any part with
    no event before that), and the same to the last part's z_trail."""
    E = sum(p.n_events for p in parts)
    K = sum(p.total_kept for p in parts)
    flat = gather_flat([p.flat for p in parts], merged_index(parts))
    # cz[i]: the quiet probes trailing parts 0..i-1; a part with events
    # receives those since the last part with events before it
    zt = torch.cat([p.flat[-1:] for p in parts]).to(torch.int64)
    cz = torch.cat([zt.new_zeros(1), torch.cumsum(zt, 0)])
    rows, last, e0 = [], 0, 0  # (position in flat, part, carry since)
    for i, p in enumerate(parts):
        if p.n_events:
            rows.append((E + e0, i, last))
            last, e0 = i, e0 + p.n_events
    rows.append((3 * E + K, len(parts) - 1, last))  # z_trail
    pos, at, since = torch.tensor(rows, dtype=torch.int64).to(flat.device).T
    flat[pos] += (cz[at] - cz[since]).to(torch.int32)
    return ScanResult(flat, E, K)


def chain_on_device(res, settings, m_offset: int = 0) -> list:
    """Raw families of one chunk's KD result ``res`` (None: too short to
    probe; a :class:`Sliced` chunk: all its slices scanned, then merged by
    :func:`merge_slices` and let go), chained by KN on its device: the
    events are read in place from ``res.flat``, the matches shifted by
    ``m_offset`` in int64 inside the kernel, and only the family rows come
    back. No host chain runs, whatever happens."""
    if res is None:
        return []
    if isinstance(res, Sliced):
        res = merge_slices(list(res))
    if res.n_events == 0:
        return []
    ev = events_from_flat(res.flat, res.n_events, res.total_kept, m_offset)
    return chain_events_tensors(ev, config_for(settings))[0]


def chain_chunk_events(events, settings, m_offset: int = 0) -> list:
    """The host event chain: raw families of each chunk's events
    (:func:`host_events`), the matches shifted by ``m_offset`` in int64 (a
    merge-join engine's window start); touches no device memory."""
    k = settings.probe_size
    out = []
    for e in events:
        if e is None:
            out.append([])
            continue
        ev, m, z_trail = e
        if m_offset:
            m = m.astype(np.int64) + m_offset
        m_offsets = np.zeros(ev.shape[1] + 1, dtype=np.int64)
        np.cumsum(ev[2], out=m_offsets[1:])
        out.append(native.chain_events(
            ev[0], ev[1], m_offsets, m, z_trail=z_trail,
            probe_size=k, step_size=k // 2,
            max_gap_size=settings.max_gap_size,
            min_duplication_length=settings.min_duplication_length,
            max_cardinality=settings.max_cardinality))
    return out
