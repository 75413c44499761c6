"""End-to-end search: prepare -> index -> scan + chain -> post -> result.

Counterpart of ``asgart_tpu.pipeline.search_duplications``
(asgart_tpu/pipeline.py:674-944) and ``_search_duplications_sharded``
(:358-525) on one device, or on the ranks of a process group
(``distributed.py``): the whole genome, one trim window
(``settings.trim``), or ``shards`` trim windows whose families are
concatenated in window order. The host stages below (``probe_positions``
through ``SearchEngine``, and ``_finalize_result``) are copies of the JAX
package's; ``SearchEngine``'s device lookups (seed.py) run under the
engine name ``"cuda"`` on an explicit device.
tests/test_torch_host_copies.py pins them against their originals.

Device routes, in the JAX package's order (pipeline.py:567-642, :761-848),
chosen by free device memory alone:

- a trim window: the fused build if it fits, else the merge-join window
  engine (k <= 20) if it fits;
- the whole genome: the fused build, else the table engine
  (table_index.py, :642's ``DeviceEngine``), else at k = 21 the
  ``SearchEngine`` with its position tables on the device (:880: the
  host builds the doubled-text index, the device reads each probe's range
  from its table; chunks one at a time, :910-911), else the merge-join
  engine over one window (0, n1 - 1; k <= 20), else (k <= 20) the
  auto-shard planner's windows;
- with ``checkpoint`` (a journal of finished chunks, :721-746 and
  :888-900, written and read alike by both engines and both packages) the
  fused build, which needs the chunk set at build time, is not used
  (:763): the whole genome takes the table engine, else (k = 21) the
  ``SearchEngine``, else the one-window merge join; a trim window the
  merge-join engine (k <= 20); no planner runs. Chunks then run one at a
  time, in order.

Past int32 probe addressing (a probed text of ``BIG_WINDOW_SPAN`` = 2^31
bases or more: -R/-C runs of genomes over ~1.07 Gbp) the fused build, the
table and the one-window route drop out: every window takes the
merge-join engine, whose index keeps window positions (the JAX
``BigWindowEngine``'s route, k <= 20, W < 2^30, chunks under 2^30 bases;
pipeline.py:630-636), and the whole genome the planner's windows, sized by
the same fit (:796-810). A sharded run picks one route for all its
windows before any window runs. With ``engine="cuda"`` every input the
port does not cover raises ``NotImplementedError`` naming its route; no
failure falls back to another engine. Where the JAX package's
``engine="tpu"`` quietly switches to its host engine, the port raises:
k > 30 (:137-145), a k = 21..30 trim window beyond the fused build
(:768-774, journaled ones included), a genome beyond the table that no S
<= 256 holds (or, at k = 22..30, beyond the fused build and the table;
:843-848), ``--checkpoint`` beyond the table and the one-window merge join
(:786), and no CUDA device (:869-877). At k = 21 past int32 probe
addressing it raises where the JAX run raises, in ``DevicePositionTables``.

With ``ASGART_DEVICE_CHAIN`` set, every device engine chains its chunks'
events on the device (KN, device_engine.py) in place of the host event
chain; a sharded run then chains each window on this thread, and its tail
thread only post-processes.

A trim window takes the rank-sharded window engine
(``ShardedWindowEngine``) after the fused build and before the merge-join
engine where ``rank_sharded_window_applies`` (``ASGART_RANK_SHARDED=1``
forces it at any world size; otherwise a window beyond one device's merge
join that the ranks' shards hold), as the JAX adapter checks it
(:571-629); so does the whole genome's one-window route. Under a process
group (``distributed.py``) ``n_dev`` is the world size, as the JAX package
takes ``len(jax.devices())``; the route reads free memory once, the least
over the ranks (one ``all_min`` a search, or a sharded run), so every
rank takes the same route. With more than one rank no fused build runs
(device_engine.py:2119), and every route has a form on the ranks, each
rank ending with the whole result:

- the whole genome: the table engine's probe-axis scan (each rank its
  lanes of every chunk, gathered), journaled or not;
- ``--shards S`` and the planner's windows, k <= 20: the windows x probes
  ``MeshWindowEngine`` where the ranks tile the windows (D >= S, S
  dividing D; :408-409, :func:`window_layout`), else the windows one
  after another, each on every rank;
- a trim window, the one-window whole genome and each window of a
  sequential sharded run: the rank-sharded engine where it applies, else
  the merge-join engine, which every rank runs on its own device, as the
  JAX adapter runs it on one device of its mesh (:552-640);
- the k = 21 ``SearchEngine``: every rank runs it on its own device;
- ``--checkpoint``: every rank reads the journal and runs every chunk;
  rank 0 alone writes it (:class:`Journal`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import native, postprocess
from .codes import upload_codes
from .device import cuda_device
from . import distributed
from .device_engine import (DeviceWindowEngine, FusedEngine,
                            MeshWindowEngine, ShardedWindowEngine,
                            TableEngine, chunk_specs, families)
from .distributed import all_min, world
from .fasta import Strand, prepare_data
from .fused_index import (INDEX_CACHE, MAX_K, MJ_MAX_K, fits, free_bytes,
                          mj_fits, mj_window_fits_bytes, probe_span,
                          table_fits,
                          window_fits_bytes)
from .host_helpers import rank_sharded_window_applies
from .index import CODE, MAX_PROBE_SIZE, ByteIndex, GenomeIndex, PositionIndex
from .structs import ProtoSD, RunResult, RunSettings, SD, StrandResult
from .utils import complemented
from .window_index import ProbeKeyCache

log = logging.getLogger("asgart")

ENGINES = ("host", "cuda")
MAX_SHARDS = 256  # the auto-shard planner's bound (pipeline.py:813)
# probed-text length from which the fused build drops out and every window
# takes the merge-join engine: int32 probe addressing ends there
# (pipeline.py:630)
BIG_WINDOW_SPAN = 1 << 31


def probe_positions(needle: np.ndarray, probe_size: int) -> np.ndarray:
    """Needle indices probed by the automaton: ``i = step, 2*step, …`` while
    ``i < len - probe - step`` pre-increment (automaton.rs:90-97), minus
    probes starting with 'N' (automaton.rs:100-102)."""
    step = probe_size // 2
    bound = len(needle) - probe_size - step
    if bound <= 0:
        return np.zeros(0, dtype=np.int64)
    last = ((bound - 1) // step) * step + step  # largest i reached
    is_ = np.arange(step, last + 1, step, dtype=np.int64)
    return is_[needle[is_] != ord("N")]


def transform_needle(chunk: np.ndarray, reverse: bool,
                     complement: bool) -> np.ndarray:
    """R/C needle transform (asgart.rs:206-218): complement first, then
    reverse."""
    needle = chunk
    if complement:
        needle = complemented(needle)
    if reverse:
        needle = needle[::-1]
    return np.ascontiguousarray(needle)


def _pack_probe_kmers(needle_codes_padded: np.ndarray, is_: np.ndarray,
                      k: int) -> np.ndarray:
    out = np.zeros(len(is_), dtype=np.int64)
    for j in range(k):
        out <<= 3
        out |= needle_codes_padded[is_ + j].astype(np.int64)
    return out


def raw_families_to_protosds(raw_families, s: RunSettings, start: int,
                             length: int) -> list[list[ProtoSD]]:
    """Chunk-engine output → ProtoSDs in global coordinates with
    direction flags stamped (coordinate fixup, asgart.rs:229-253)."""
    families = []
    for fam in raw_families:
        family = []
        for (left, right, llen, rlen) in fam:
            if not s.reverse:
                left = left + start
            else:
                left = start + length - left - llen
            family.append(ProtoSD(
                left=left, right=right,
                left_length=llen, right_length=rlen,
                identity=0.0,
                reversed=s.reverse, complemented=s.complement))
        families.append(family)
    return families


class SearchEngine:
    """Seed lookup + chaining over one prepared strand (see the module
    docstring for the strategy matrix)."""

    def __init__(self, strand: Strand, settings: RunSettings,
                 trim: Optional[tuple[int, int]], engine: str = "host",
                 attach_device: bool = True,
                 device: Optional[torch.device] = None,
                 index_cache: Optional[str] = None):
        self.strand = strand
        self.settings = settings
        self.engine = engine
        t0 = time.time()
        self.pidx: Optional[PositionIndex] = None
        self.index: Optional[GenomeIndex] = None
        self.bidx: Optional[ByteIndex] = None
        transformed = settings.reverse or settings.complement
        if settings.probe_size > MAX_PROBE_SIZE:
            # wide probes: full SA + byte-compare equal-range (the
            # reference's own strategy for arbitrary k); host engine
            if engine == "cuda":
                log.warning("probe_size > %d runs on the host engine",
                            MAX_PROBE_SIZE)
            self.bidx = ByteIndex.build(
                strand.data, settings.probe_size, trim=trim,
                n_threads=settings.threads_count or 0)
        elif trim is None and index_cache is not None and engine != "cuda":
            # one cached single-text index serves every run mode
            self.pidx = PositionIndex.build_single_cached(
                strand.data, settings.probe_size, index_cache,
                n_threads=settings.threads_count or 0)
        elif trim is None:
            if engine == "cuda" or not transformed:
                # table strategy: every probe is one gather (device-ready);
                # direct runs need no appended half
                self.pidx = PositionIndex.build(
                    strand.data, settings.probe_size,
                    reverse=settings.reverse,
                    complement=settings.complement,
                    n_threads=settings.threads_count or 0)
            else:
                # host fast path for R/C/RC: single text + batched search
                self.pidx = PositionIndex.build_single(
                    strand.data, settings.probe_size,
                    n_threads=settings.threads_count or 0)
        else:
            self.index = GenomeIndex.build(
                strand.data, settings.probe_size, trim=trim)
        log.debug("Index built in %.2fs", time.time() - t0)
        self._device = None
        if engine == "cuda" and attach_device and self.bidx is None:
            # (wide probes run fully on the host: no device attachment)
            if self.pidx is not None:
                from .seed import DevicePositionTables
                self._device = DevicePositionTables(self.pidx, device)
            elif settings.probe_size * 3 <= 60:
                from .seed import DeviceSeedIndex
                self._device = DeviceSeedIndex(self.index, device)
            else:
                # k=21 exceeds the two-plane device packing: host lookup
                log.warning("probe_size %d trim lookup runs on the host",
                            settings.probe_size)

    def run_chunk(self, chunk: tuple[int, int]) -> list[list[ProtoSD]]:
        """Search one chunk; returns families in global coordinates with
        direction flags stamped (asgart.rs:201-253)."""
        s = self.settings
        start, length = chunk
        needle = transform_needle(
            self.strand.data[start: start + length], s.reverse, s.complement)

        if len(needle) < s.min_duplication_length:
            return []

        is_ = probe_positions(needle, s.probe_size)
        if len(is_) == 0:
            return []

        k = s.probe_size
        transformed = s.reverse or s.complement
        if self.bidx is not None:
            padded = np.zeros(len(needle) + k, dtype=np.uint8)
            padded[:len(needle)] = needle
            lo, hi = self.bidx.lookup_needle(
                padded, is_, n_threads=s.threads_count or 0)
            sa = self.bidx.sa
            max_match_pos = 1 << 62
        elif self.pidx is not None:
            needs_search = transformed and not (
                self.pidx.reverse or self.pidx.complement)
            if needs_search:
                # single-text strategy: transformed probes by value
                pk = native.pack_at(CODE[needle], k, is_,
                                    s.threads_count or 0)
                lo, hi = self.pidx.search_ranges(
                    pk, s.threads_count or 0)
            elif self._device is not None:
                x = self.pidx.probe_table_positions(start, length, is_)
                lo, hi = self._device.gather_ranges(x)
            else:
                lo, hi = self.pidx.probe_ranges(start, length, is_)
            sa = self.pidx.sa
            max_match_pos = self.pidx.first_len - 1
        else:
            codes = np.zeros(len(needle) + k, dtype=np.uint8)
            codes[:len(needle)] = CODE[needle]
            probe_kmers = _pack_probe_kmers(codes, is_, k)
            if self._device is not None:
                lo, hi = self._device.lookup(probe_kmers)
            else:
                lo, hi = self.index.lookup(probe_kmers)
            sa = self.index.sa
            max_match_pos = 1 << 62

        raw_families = native.chain(
            sa, is_, lo, hi,
            probe_size=s.probe_size,
            step_size=s.probe_size // 2,
            max_gap_size=s.max_gap_size,
            min_duplication_length=s.min_duplication_length,
            max_cardinality=s.max_cardinality,
            needle_offset=start,
            needle_len=len(needle),
            reverse=s.reverse,
            max_match_pos=max_match_pos,
        )

        return raw_families_to_protosds(raw_families, s, start, length)


def _finalize_result(families: list[list[ProtoSD]], strand: Strand,
                     settings: RunSettings) -> RunResult:
    """Post-processing Step chain + chromosome projection (the pipeline
    tail, asgart.rs:81-112,776-821) — shared by the single-run path and
    the per-window finalization of sharded runs."""
    strand_bytes = strand.data.tobytes()
    log.info("[2] Filtering uncertain duplications...")
    families = postprocess.filter_ns(families, strand_bytes)
    log.info("[3] Re-ordering...")
    families = postprocess.re_order(families)
    log.info("[4] Reducing overlap...")
    families = postprocess.reduce_overlap(families)
    if settings.compute_score:
        log.info("[5] Computing Levenshtein distance...")
        families = postprocess.compute_score(families, strand_bytes)
    log.info("[%d] Sorting...", 6 if settings.compute_score else 5)
    families = postprocess.sort_families(families)

    strand_result = StrandResult(
        name=strand.file_names,
        length=sum(chr_.length for chr_ in strand.map),
        map=list(strand.map),
    )

    def project(sd: ProtoSD) -> SD:
        cl = strand_result.find_chr_by_pos(sd.left)
        cr = strand_result.find_chr_by_pos(sd.right)
        return SD(
            chr_left=cl.name if cl else "unknown",
            chr_right=cr.name if cr else "unknown",
            global_left_position=sd.left,
            global_right_position=sd.right,
            chr_left_position=sd.left - (cl.position if cl else 0),
            chr_right_position=sd.right - (cr.position if cr else 0),
            left_length=sd.left_length,
            right_length=sd.right_length,
            left_seq=None,
            right_seq=None,
            identity=sd.identity,
            reversed=sd.reversed,
            complemented=sd.complemented,
        )

    return RunResult(
        strand=strand_result,
        settings=settings,
        families=[[project(sd) for sd in fam] for fam in families],
    )


def _cuda_checks(settings: RunSettings) -> None:
    if settings.probe_size > MAX_K:
        raise NotImplementedError(
            f"probe_size > {MAX_K} has no device route: the asgart_tpu "
            "package serves those probe sizes on its host engine; use "
            "engine='host'")
    if settings.probe_size < 2:
        raise NotImplementedError(
            "probe_size 1 gives a probe step of 0, which no engine of "
            "the asgart_tpu package runs either (ROADMAP F6)")


def _doubled(settings: RunSettings) -> bool:
    return settings.reverse or settings.complement


def _big(n1: int, settings: RunSettings) -> bool:
    """Whether the probed text passes int32 addressing (no fused build
    holds it)."""
    return probe_span(n1, _doubled(settings)) >= BIG_WINDOW_SPAN


def _too_large(n1: int, settings: RunSettings, what: str):
    """The refusal of a build no device route of the port holds."""
    k = settings.probe_size
    if _big(n1, settings) and k > MJ_MAX_K:
        return NotImplementedError(
            f"{what} beyond int32 probe addressing at probe_size {k} runs "
            "on the host engine in the asgart_tpu package (its big-window "
            f"engine holds probe sizes up to {MJ_MAX_K}); use "
            "engine='host'")
    if k > MJ_MAX_K:
        return NotImplementedError(
            f"{what} beyond one device's fused build and table at "
            f"probe_size {k} runs on the host engine in the asgart_tpu "
            "package, with whole-genome semantics (its merge-join engines "
            f"and auto-shard planner hold probe sizes up to {MJ_MAX_K}); "
            "use engine='host'")
    return NotImplementedError(
        f"{what} fits no device route of the cuda engine on this device "
        "(no fused build, table or merge-join window engine holds it); "
        "use more --shards or engine='host'")


def _window_route(n1: int, W: int, settings: RunSettings, device,
                  resident: int, keys_held: bool = False,
                  chunk_len: int = 0, journal: bool = False,
                  free: Optional[float] = None):
    """The engine class of a W-row trim window, from ``free`` device bytes
    (the least over a group's ranks, as :func:`search_duplications`
    agrees it; ``device``'s :func:`free_bytes` when None, as in a sharded
    run, which has one rank): :class:`FusedEngine` if its build fits
    (``resident`` bytes held beside it), the probed text is within int32
    addressing, no ``journal`` is kept and there is one rank,
    else :class:`ShardedWindowEngine` where
    ``rank_sharded_window_applies`` (``ASGART_RANK_SHARDED=1``, or a
    window beyond one device's merge join that the ranks' shards hold),
    else :class:`DeviceWindowEngine` if the merge-join engine fits
    (``keys_held``: a sharded run's probe keys stay cached beside each
    later window's build). Past int32 addressing the merge-join engines
    take only chunks under 2^30 bases (``chunk_len``: the longest), as
    the JAX ``BigWindowEngine`` does. Raises when no route holds the
    window. Under a process group of more than one rank every rank runs
    the route it returns, the merge-join engine on its own device."""
    k = settings.probe_size
    big = _big(n1, settings)
    free = free_bytes(device) if free is None else free
    mesh = world() > 1  # no fused build on a mesh (device_engine.py:2119)
    if not mesh and not big and not journal and \
            fits(n1, W, k, _doubled(settings), free, resident):
        return FusedEngine
    if k > MJ_MAX_K:
        if big:
            raise _too_large(n1, settings, f"a {W}-row trim window")
        beyond = "with --checkpoint (no fused build keeps a journal)" \
            if journal else "beyond one device's fused build"
        raise NotImplementedError(
            f"a {W}-row trim window at probe_size {k} {beyond} runs on the "
            "host engine in the asgart_tpu package (its merge-join window "
            f"engines hold probe sizes up to {MJ_MAX_K}); use "
            "engine='host'")
    if big and chunk_len >= (1 << 30):
        raise NotImplementedError(
            f"a chunk of {chunk_len} bases (an N-free run of 2^30 or more) "
            "beyond int32 probe addressing has no device route: the "
            "asgart_tpu package's big-window engine needs chunks under "
            "2^30 bases; use engine='host'")
    if rank_sharded_window_applies(n1, W, _doubled(settings), k=k,
                                   free=free):
        return ShardedWindowEngine
    if mj_fits(n1, W, k, free, resident, keys_held):
        return DeviceWindowEngine
    raise _too_large(n1, settings, f"a {W}-row trim window")


def plan_windows(total_len: int, shards: int) -> list:
    """``shards`` equal trim windows over the genome's ``total_len`` bases
    (pipeline.py:384-388): (ws, we) pairs, empty ones dropped."""
    per = (total_len + shards - 1) // shards
    windows = [(w * per, min(total_len, (w + 1) * per))
               for w in range(shards)]
    return [w for w in windows if w[0] < w[1]]


def window_layout(n_dev: int, n_windows: int) -> tuple[str, int, int]:
    """How ``n_dev`` ranks run a sharded run's ``n_windows`` windows
    (non-empty, :func:`plan_windows`) at k <= 20, as the JAX package
    decides it (pipeline.py:408-409): ("mesh", S, P), the windows x probes
    mesh of S = n_windows windows and P = n_dev / S ranks each, when
    ``n_dev > 1``, ``n_dev >= n_windows`` and ``n_windows`` divides
    ``n_dev``; else ("sequential", n_windows, 1), the windows one after
    another, each on every rank."""
    if n_dev > 1 and n_dev >= n_windows and n_dev % n_windows == 0:
        return "mesh", n_windows, n_dev // n_windows
    return "sequential", n_windows, 1


def plan_shards(n1: int, k: int, doubled: bool, free: float,
                fused: bool = True) -> Optional[int]:
    """The auto-shard planner (pipeline.py:786-842 without its join-single
    refinement, which only bounds the JAX co-sort): the smallest S in
    2..256 whose windows fit ``free`` device bytes next to the n1
    resident code bytes, in a fused build (unless not ``fused``: no fused
    build runs under a process group) or in the merge-join engine (its
    probe keys held across the windows; past int32 probe addressing only
    the merge-join engine, :796-810), or None (no S fits). None at k >
    20: there the JAX package keeps whole-genome semantics, since its
    planner runs only where its merge-join engines do (:768-778)."""
    if k > MJ_MAX_K:
        return None
    big = probe_span(n1, doubled) >= BIG_WINDOW_SPAN
    total_len = n1 - 1
    for S in range(2, MAX_SHARDS + 1):
        W = (total_len + S - 1) // S + 1
        if (fused and not big
                and window_fits_bytes(n1, W, k, free, resident=n1)) \
                or mj_window_fits_bytes(n1, W, k, free, resident=n1,
                                        keys_held=True):
            return S
    return None


def _longest(chunks) -> int:
    return max((int(length) for _, length in chunks), default=0)


def _protosds(raws, chunks, settings) -> list:
    families = []
    for (start, length), raw in zip(chunks, raws):
        families.extend(raw_families_to_protosds(raw, settings, start,
                                                 length))
    return families


class Journal:
    """The ``--checkpoint`` journal, as the JAX package keeps it
    (asgart_tpu/pipeline.py:721-746, 888-900), so a journal either
    package wrote resumes in the other: a header line (``files``,
    ``settings.to_json_obj()``, ``reverse``, ``complement``), then one
    line per finished chunk, ``{"chunk": [start, length], "families":
    [[ProtoSD fields, ...], ...]}``, flushed as it is written. A journal
    whose header differs is started afresh."""

    def __init__(self, path: str, files: list, settings: RunSettings):
        header = {"files": files, "settings": settings.to_json_obj(),
                  "reverse": settings.reverse,
                  "complement": settings.complement}
        self.done: dict = {}
        if os.path.exists(path):
            with open(path) as fh:
                lines = fh.read().splitlines()
            if lines and json.loads(lines[0]) == header:
                for line in lines[1:]:
                    rec = json.loads(line)
                    self.done[tuple(rec["chunk"])] = rec["families"]
                log.info("checkpoint: %d chunks already done",
                         len(self.done))
            else:
                log.warning("checkpoint mismatch; starting fresh")
        self.path = path
        self.header = header
        # every rank must restore the same chunks, or the ranks' collectives
        # pair different chunks (a node-local path, a stale read); this
        # collective also keeps rank 0 from writing before every rank read
        digest = hashlib.sha256(json.dumps(
            [[list(c), self.done[c]] for c in sorted(self.done)],
            sort_keys=True).encode()).digest()
        if not distributed.agree(float(int.from_bytes(digest[:6], "big"))):
            raise RuntimeError(
                f"the ranks read different checkpoint journals at {path}; "
                "every rank must read the same file")

    def todo(self, chunks) -> list:
        """The chunks without a record."""
        return [c for c in chunks if tuple(c) not in self.done]

    def run(self, chunks, run_chunk) -> list:
        """Every chunk's families (ProtoSDs) in chunk order: restored from
        its record, or ``run_chunk(chunk)`` and recorded; one chunk at a
        time. Under a process group every rank read the same journal
        (checked when it was read), so all restore the same chunks and run
        the others together; rank 0 alone writes."""
        families = []
        with contextlib.ExitStack() as stack:
            fh = None
            if distributed.rank() == 0:
                fh = stack.enter_context(
                    open(self.path, "a" if self.done else "w"))
                if not self.done:
                    fh.write(json.dumps(self.header) + "\n")
                    fh.flush()
            for chunk in chunks:
                rec = self.done.get(tuple(chunk))
                if rec is not None:
                    families.extend([ProtoSD(**sd) for sd in fam]
                                    for fam in rec)
                    continue
                fams = run_chunk(chunk)
                if fh is not None:
                    fh.write(json.dumps({
                        "chunk": list(chunk),
                        "families": [[vars(sd) for sd in fam]
                                     for fam in fams]}) + "\n")
                    fh.flush()
                families.extend(fams)
        return families


def _whole_route(n1: int, settings: RunSettings, device, journal: bool,
                 free: Optional[float] = None):
    """The whole genome's engine, from ``free`` device bytes (as in
    :func:`_window_route`): (engine class, trim) with trim (0, n1 - 1)
    for the one-window merge join, :class:`SearchEngine` with its device
    position tables at k = 21, or the planner's S (an int) for an
    auto-sharded run; raises when no route holds the genome (module
    docstring)."""
    k = settings.probe_size
    doubled = _doubled(settings)
    big = _big(n1, settings)
    free = free_bytes(device) if free is None else free
    mesh = world() > 1  # no fused build on a mesh (device_engine.py:2119)
    if not mesh and not big and not journal and \
            fits(n1, n1, k, doubled, free):
        return FusedEngine, None
    if not big and table_fits(n1, k, doubled, free):
        if not journal:
            log.info("whole-genome fused build exceeds the device; using "
                     "the table engine")
        return TableEngine, None
    if k == MAX_PROBE_SIZE:
        if big:
            raise NotImplementedError(
                f"a genome beyond int32 probe addressing at probe_size {k} "
                "has no device route: the asgart_tpu package's "
                "engine='tpu' builds its host position index there, then "
                "raises ValueError in DevicePositionTables (its table "
                "passes 2^31 rows); use engine='host'")
        # the JAX package's SearchEngine(engine="tpu") (pipeline.py:880):
        # the doubled-text position index on the host, its range table on
        # the device (seed.py); no fit check, as there
        log.info("whole-genome fused build and table exceed the device at "
                 "probe_size %d; using the device position tables", k)
        return SearchEngine, None
    # the whole genome as the one window (0, n1 - 1): its text is the
    # genome and its '$', so the output is the whole genome's
    # (pipeline.py:591-604); the settings stay untrimmed; rank-sharded
    # where that applies, as the JAX adapter checks it there (:620-629)
    if not big and k <= MJ_MAX_K and rank_sharded_window_applies(
            n1, n1, doubled, k=k, free=free):
        log.info("whole-genome table exceeds the device; using the "
                 "one-window rank-sharded engine")
        return ShardedWindowEngine, (0, n1 - 1)
    if not big and mj_fits(n1, n1, k, free, resident=n1):
        log.info("whole-genome table exceeds the device; using the "
                 "one-window merge-join device engine")
        return DeviceWindowEngine, (0, n1 - 1)
    if journal:
        raise NotImplementedError(
            "--checkpoint with a genome beyond one device's table and "
            "one-window merge join runs on the host engine in the "
            "asgart_tpu package (a journaled run is not auto-sharded); "
            "use engine='host'")
    S = plan_shards(n1, k, doubled, free, not mesh)
    if S is None:
        raise _too_large(n1, settings, "a genome, in any number of "
                         f"windows up to {MAX_SHARDS},")
    return None, S


def _host_families(se: SearchEngine, to_process, settings) -> list:
    """The chunks' families on the host engine ``se``, in chunk order
    (chunks run on ``threads_count`` threads)."""
    workers = settings.threads_count or os.cpu_count() or 1
    families = []
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for fams in ex.map(se.run_chunk, to_process):
            families.extend(fams)
    return families


def search_duplications(
    strands_files: list[str],
    settings: RunSettings,
    engine: str = "cuda",
    device: Optional[torch.device] = None,
    checkpoint: Optional[str] = None,
    shards: int = 1,
    index_cache: Optional[str] = None,
    profile: Optional[dict] = None,
) -> RunResult:
    """Find the segmental duplications of ``strands_files``.

    ``engine="cuda"`` runs the device engines on ``device`` (default
    :func:`~asgart_tpu_torch.device.cuda_device`; pass
    ``torch.device("cpu")`` for the plain PyTorch versions of the
    kernels); ``engine="host"`` runs the host ``SearchEngine``
    (``index_cache`` applies to it only). ``settings.trim`` indexes one
    window; ``shards`` > 1 indexes that many windows in turn. A genome
    whose whole fused build does not fit the device runs on the table
    engine, at k = 21 on the ``SearchEngine`` with its device position
    tables, as one merge-join window, or sharded automatically (module
    docstring). ``checkpoint``: the path of a journal of finished chunks,
    which a rerun with the same files and settings restores instead of
    scanning them again (on either engine). ``profile``: dict to fill
    with phase timings. Under a process group of ranks (``distributed``)
    every rank calls this with the same arguments and its own device,
    and each returns the whole result (module docstring)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}")
    if not (1 <= settings.probe_size <= 10000):
        raise ValueError(
            f"probe_size {settings.probe_size} is out of range (1..10000)")
    if engine == "cuda":
        _cuda_checks(settings)
        device = device if device is not None else cuda_device()
    if shards > 1:
        if settings.trim is not None:
            raise ValueError("--shards cannot be combined with --trim")
        if checkpoint is not None:
            log.warning("--checkpoint is not supported with --shards; "
                        "windows restart from scratch on failure")
        if index_cache is not None:
            log.warning("--index-cache applies to whole-genome indexes "
                        "only and is ignored with --shards")
        return _search_duplications_sharded(strands_files, settings, shards,
                                            engine, device, profile)
    prof = profile if profile is not None else {}
    total = time.time()
    t0 = time.time()
    trim, to_process, strand = prepare_data(
        strands_files, settings.skip_masked, settings.trim)
    prof["prepare_s"] = round(time.time() - t0, 3)
    journal = None if checkpoint is None else \
        Journal(checkpoint, strands_files, settings)

    t0 = time.time()
    route = SearchEngine
    if engine == "cuda":
        n1 = int(len(strand.data))
        # the route's one collective: every rank routes from the group's
        # least free memory (ranks that share a card see each other's
        # allocations), so all take the same route and meet in the same
        # collectives
        free = all_min(free_bytes(device))
        if trim is not None:
            route = _window_route(n1, trim[1] - trim[0] + 1, settings,
                                  device, resident=n1,
                                  chunk_len=_longest(to_process),
                                  journal=journal is not None, free=free)
        else:
            route, trim = _whole_route(n1, settings, device,
                                       journal is not None, free)
            if route is None:  # the planner's number of windows
                log.warning(
                    "genome too large for a one-HBM device index; "
                    "auto-sharding into %d trim windows — output is "
                    "byte-equal to the reference's --trim + merge "
                    "workflow (families never span windows); run with "
                    "engine=host for whole-genome trim-free semantics",
                    trim)
                return _search_duplications_sharded(
                    strands_files, settings, trim, "cuda", device, profile)
    if route is SearchEngine:
        se = SearchEngine(strand, settings, trim, engine=engine,
                          device=device, index_cache=index_cache)
        prof["index_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        if journal is not None:
            families = journal.run(to_process, se.run_chunk)
        elif engine == "host":
            families = _host_families(se, to_process, settings)
        else:  # one device queue: one chunk at a time (pipeline.py:910)
            families = [fam for c in to_process for fam in se.run_chunk(c)]
    else:
        eng = route(strand, settings, device, **(
            {} if trim is None else {"trim": trim}))
        if journal is None or journal.todo(to_process):
            eng.ensure_index(to_process)
        prof["index_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        if journal is None:
            families = _protosds(eng.run_chunks(to_process), to_process,
                                 settings)
        else:
            families = journal.run(
                to_process, lambda c: raw_families_to_protosds(
                    eng.run_chunk(c), settings, c[0], c[1]))
    prof["scan_s"] = round(time.time() - t0, 3)

    t0 = time.time()
    result = _finalize_result(families, strand, settings)
    prof["post_s"] = round(time.time() - t0, 3)
    prof["total_s"] = round(time.time() - total, 3)
    log.info("%s processed in %.2fs", ", ".join(strands_files),
             time.time() - total)
    return result


def _search_duplications_sharded(strands_files, settings, shards, engine,
                                 device, profile) -> RunResult:
    """Index-sharded run (pipeline.py:358-525): the genome is split into
    ``shards`` equal trim windows; each window gets its own index while
    the whole genome is probed against it, and the per-window families
    are concatenated in window order, byte-equal to the reference's
    sequential ``--trim`` runs merged (asgart.rs:142-148,433-463).
    Host windows run on a thread pool; device windows on the ranks'
    windows x probes mesh where :func:`window_layout` gives one
    (:func:`_run_mesh_windows`), else in turn, each one's host tail
    overlapping the next one's device phase (:func:`_run_cuda_windows`)."""
    prof = profile if profile is not None else {}
    t0 = time.time()
    _, to_process, strand = prepare_data(
        strands_files, settings.skip_masked, None)
    windows = plan_windows(int(len(strand.data)) - 1, shards)
    prof["prepare_s"] = round(time.time() - t0, 3)

    t0 = time.time()
    if engine == "cuda" and settings.probe_size <= MJ_MAX_K \
            and window_layout(world(), len(windows))[0] == "mesh":
        results = _run_mesh_windows(windows, to_process, strand, settings,
                                    device, prof)
    elif engine == "cuda":
        results = _run_cuda_windows(windows, to_process, strand, settings,
                                    device)
    else:
        def run_window(w):
            s = dataclasses.replace(settings, trim=w)
            se = SearchEngine(strand, s, w, engine="host")
            return _finalize_result(_host_families(se, to_process, s),
                                    strand, s)

        with ThreadPoolExecutor(max_workers=min(len(windows),
                                                os.cpu_count() or 1)) as ex:
            results = list(ex.map(run_window, windows))
    prof["scan_s"] = round(time.time() - t0, 3)

    merged = results[0]
    for r in results[1:]:
        merged.families.extend(r.families)
    merged.settings = settings  # the user's settings, not a window's
    return merged


def _window_tail(events, to_process, strand, settings, m_offset: int = 0
                 ) -> RunResult:
    """Host phase of one device window: its chunks' raw families
    (:func:`device_engine.families`: the host chain of the chunks not
    chained on the device, their matches shifted by ``m_offset``, a
    merge-join window's start), then the post-processing Step chain."""
    raws = families(events, settings, m_offset)
    return _finalize_result(_protosds(raws, to_process, settings), strand,
                            settings)


def _run_cuda_windows(windows, to_process, strand, settings, device
                      ) -> list:
    """The device windows of a sharded run, results in window order
    (pipeline.py:288-355). One route serves every window: it is chosen
    for the first, largest window (:func:`_window_route`, the merge-join
    engine charged for the probe keys it holds across windows) before
    anything is allocated, so a run no route holds fails before any window
    runs. This thread runs each window's device phase (build, scans,
    downloads, and with ``ASGART_DEVICE_CHAIN`` the chain on the device)
    in turn; one tail thread runs each window's host phase
    (:func:`_window_tail`) while the next window's device phase runs. The
    tail holds no device memory (the scans' outputs, or the chained
    families, are already on the host), so no headroom check gates the
    overlap. A window's failure fails the run: nothing reruns a window or
    moves it to the host engine."""
    # the one-entry index cache cannot hold a window set: free it, and
    # build the windows uncached
    INDEX_CACHE.clear()
    n1 = int(len(strand.data))
    ws, we = windows[0]
    route = _window_route(n1, we - ws + 1, settings, device, resident=n1,
                          keys_held=True, chunk_len=_longest(to_process),
                          free=all_min(free_bytes(device)))
    codes = upload_codes(strand.data, device)  # once for every window
    extra = {}
    if route is DeviceWindowEngine:  # the probe keys, packed once
        extra["probe_cache"] = ProbeKeyCache()
    tails = []
    with ThreadPoolExecutor(max_workers=1) as tail_ex:
        for w in windows:
            s = dataclasses.replace(settings, trim=w)
            eng = route(strand, s, device, trim=w, cache=None, codes=codes,
                        **extra)
            events = eng.scan_chunks(to_process)
            tails.append(tail_ex.submit(_window_tail, events, to_process,
                                        strand, s, eng.m_offset))
            del eng  # and its index, before the next window's build
    return [t.result() for t in tails]


def _run_mesh_windows(windows, to_process, strand, settings, device,
                      prof: dict) -> list:
    """The windows of a sharded run on the ranks' windows x probes mesh
    (pipeline.py:393-434): this rank builds its window's merge-join index
    and scans its probe slice of every chunk (:class:`MeshWindowEngine`);
    every rank then holds every window's events and finalizes each window
    alone, with the user's untrimmed settings (:422-429). Raises on every
    rank when one rank's merge join cannot hold the largest window in the
    group's least free memory (the JAX engine would run out of memory
    there), and past int32 probe addressing, as the JAX engine does.
    ``prof["mesh"]``: this rank's cell, its window and its lanes of each
    chunk."""
    INDEX_CACHE.clear()
    n1 = int(len(strand.data))
    eng = MeshWindowEngine(strand, settings, device, windows)
    W = max(we - ws + 1 for ws, we in windows)
    if not mj_fits(n1, W, settings.probe_size,
                   all_min(free_bytes(device)), resident=n1):
        raise _too_large(n1, settings, f"a {W}-row window of a "
                         f"{eng.S} x {eng.P} mesh")
    prof["mesh"] = {"S": eng.S, "P": eng.P, "w": eng.w, "p": eng.p,
                    "window": list(eng.trim), "lanes": [
                        b - a for (_, _, nc) in chunk_specs(to_process,
                                                            settings)
                        for a, b in [eng.part(nc)]]}
    eng.ensure_index()
    events = eng.scan_windows(to_process)
    del eng  # and its index, before the windows' host tails
    return [_window_tail(ev, to_process, strand, settings, ws)
            for ev, (ws, _) in zip(events, windows)]
