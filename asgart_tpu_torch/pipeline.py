"""End-to-end search: prepare -> index -> scan + chain -> post -> result.

Counterpart of ``asgart_tpu.pipeline.search_duplications``
(asgart_tpu/pipeline.py:674-944) and ``_search_duplications_sharded``
(:358-525) on one device: the whole genome, one trim window
(``settings.trim``), or ``shards`` trim windows whose families are
concatenated in window order. The host stages below (``probe_positions``
through ``SearchEngine``, and ``_finalize_result``) are copies of the JAX
package's, without its ``engine="tpu"`` branches;
tests/test_torch_host_copies.py pins them against their originals.

Device routes, in the JAX package's order (pipeline.py:567-640, :786-842),
chosen by free device memory alone: a window takes the fused build if it
fits, else the merge-join window engine (k <= 20) if it fits; the whole
genome takes the fused build, else the merge-join engine over one window
(0, n1 - 1), else the auto-shard planner's windows. A sharded run picks
one route for all its windows before any window runs. With
``engine="cuda"`` every input the port does not cover yet raises
``NotImplementedError`` naming its route; no failure falls back to another
engine.
"""

from __future__ import annotations

import dataclasses
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
from .device_engine import (DeviceWindowEngine, FusedEngine,
                            chain_chunk_events)
from .fasta import Strand, prepare_data
from .fused_index import (INDEX_CACHE, MAX_K, MJ_MAX_K, fits, free_bytes,
                          mj_fits, mj_window_fits_bytes, probe_span,
                          window_fits_bytes)
from .index import CODE, MAX_PROBE_SIZE, ByteIndex, GenomeIndex, PositionIndex
from .structs import ProtoSD, RunResult, RunSettings, SD, StrandResult
from .utils import complemented
from .window_index import ProbeKeyCache

log = logging.getLogger("asgart")

ENGINES = ("host", "cuda")
MAX_SHARDS = 256  # the auto-shard planner's bound (pipeline.py:813)


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
            if engine == "tpu":
                log.warning("probe_size > %d runs on the host engine",
                            MAX_PROBE_SIZE)
            self.bidx = ByteIndex.build(
                strand.data, settings.probe_size, trim=trim,
                n_threads=settings.threads_count or 0)
        elif trim is None and index_cache is not None and engine != "tpu":
            # one cached single-text index serves every run mode
            self.pidx = PositionIndex.build_single_cached(
                strand.data, settings.probe_size, index_cache,
                n_threads=settings.threads_count or 0)
        elif trim is None:
            if engine == "tpu" or not transformed:
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
            else:
                lo, hi = self.pidx.probe_ranges(start, length, is_)
            sa = self.pidx.sa
            max_match_pos = self.pidx.first_len - 1
        else:
            codes = np.zeros(len(needle) + k, dtype=np.uint8)
            codes[:len(needle)] = CODE[needle]
            probe_kmers = _pack_probe_kmers(codes, is_, k)
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


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the cuda engine yet (ROADMAP {item}); "
        "use engine='host' or the asgart_tpu package")


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


def _too_large(n1: int, settings: RunSettings, what: str):
    """The refusal of a build no device route of the port holds."""
    if probe_span(n1, _doubled(settings)) >= (1 << 31):
        return _unsupported(f"{what} beyond int32 probe addressing (the "
                            "big-window engine)", "A10")
    return NotImplementedError(
        f"{what} fits no device route of the cuda engine on this device "
        "(neither the fused build nor the merge-join window engine holds "
        "it); use more --shards or engine='host'")


def _window_route(n1: int, W: int, settings: RunSettings, device,
                  resident: int, keys_held: bool = False):
    """The engine class of a W-row trim window: :class:`FusedEngine` if
    its build fits (``resident`` bytes held beside it), else
    :class:`DeviceWindowEngine` if the merge-join engine fits
    (``keys_held``: a sharded run's probe keys stay cached beside each
    later window's build). Raises when neither holds the window."""
    k = settings.probe_size
    doubled = _doubled(settings)
    if fits(n1, W, k, doubled, device, resident):
        return FusedEngine
    if k > MJ_MAX_K:
        raise NotImplementedError(
            f"a {W}-row trim window at probe_size {k} beyond one device's "
            "fused build runs on the host engine in the asgart_tpu package "
            f"(its merge-join window engines hold probe sizes up to "
            f"{MJ_MAX_K}); use engine='host'")
    if mj_fits(n1, W, k, doubled, device, resident, keys_held):
        return DeviceWindowEngine
    raise _too_large(n1, settings, f"a {W}-row trim window")


def plan_windows(total_len: int, shards: int) -> list:
    """``shards`` equal trim windows over the genome's ``total_len`` bases
    (pipeline.py:384-388): (ws, we) pairs, empty ones dropped."""
    per = (total_len + shards - 1) // shards
    windows = [(w * per, min(total_len, (w + 1) * per))
               for w in range(shards)]
    return [w for w in windows if w[0] < w[1]]


def plan_shards(n1: int, k: int, doubled: bool, free: float
                ) -> Optional[int]:
    """The auto-shard planner (pipeline.py:786-842 without its join-single
    refinement, which only bounds the JAX co-sort): the smallest S in
    2..256 whose windows fit ``free`` device bytes next to the n1
    resident code bytes, in a fused build or in the merge-join engine
    (its probe keys held across the windows), or None (no S fits, or the genome is beyond int32 probe
    addressing)."""
    if probe_span(n1, doubled) >= (1 << 31):
        return None
    total_len = n1 - 1
    for S in range(2, MAX_SHARDS + 1):
        W = (total_len + S - 1) // S + 1
        if window_fits_bytes(n1, W, k, free, resident=n1) \
                or mj_window_fits_bytes(n1, W, k, free, resident=n1,
                                        keys_held=True):
            return S
    return None


def _protosds(raws, chunks, settings) -> list:
    families = []
    for (start, length), raw in zip(chunks, raws):
        families.extend(raw_families_to_protosds(raw, settings, start,
                                                 length))
    return families


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
    hosts: int = 1,
    index_cache: Optional[str] = None,
    profile: Optional[dict] = None,
) -> RunResult:
    """Find the segmental duplications of ``strands_files``.

    ``engine="cuda"`` runs the fused device engine on ``device`` (default
    :func:`~asgart_tpu_torch.device.cuda_device`; pass
    ``torch.device("cpu")`` for the plain PyTorch versions of the
    kernels); ``engine="host"`` runs the host ``SearchEngine``
    (``index_cache`` applies to it only). ``settings.trim`` indexes one
    window; ``shards`` > 1 indexes that many windows in turn. A genome
    whose whole fused build does not fit the device runs as one
    merge-join window, or sharded automatically (module docstring).
    ``profile``: dict to fill with phase timings."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}")
    if not (1 <= settings.probe_size <= 10000):
        raise ValueError(
            f"probe_size {settings.probe_size} is out of range (1..10000)")
    if hosts > 1:
        raise _unsupported("--hosts", "A11")
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
    if checkpoint is not None:
        raise _unsupported("--checkpoint", "A12")
    prof = profile if profile is not None else {}
    total = time.time()
    t0 = time.time()
    trim, to_process, strand = prepare_data(
        strands_files, settings.skip_masked, settings.trim)
    prof["prepare_s"] = round(time.time() - t0, 3)

    t0 = time.time()
    if engine == "cuda":
        n1 = int(len(strand.data))
        k = settings.probe_size
        doubled = _doubled(settings)
        if trim is not None:
            route = _window_route(n1, trim[1] - trim[0] + 1, settings,
                                  device, resident=n1)
            eng = route(strand, settings, device, trim=trim)
        elif fits(n1, n1, k, doubled, device):
            eng = FusedEngine(strand, settings, device)
        elif mj_fits(n1, n1, k, doubled, device, resident=n1):
            # the whole genome as the one window (0, n1 - 1): its text is
            # the genome and its '$', so the output is the whole genome's
            # (pipeline.py:591-604); the settings stay untrimmed
            log.info("whole-genome fused build exceeds the device; using "
                     "the one-window merge-join device engine")
            eng = DeviceWindowEngine(strand, settings, device, (0, n1 - 1))
        else:
            S = plan_shards(n1, k, doubled, free_bytes(device))
            if S is None:
                raise _too_large(n1, settings, "a genome, in any number of "
                                 f"windows up to {MAX_SHARDS},")
            log.warning(
                "genome too large for a one-HBM device index; "
                "auto-sharding into %d trim windows — output is "
                "byte-equal to the reference's --trim + merge "
                "workflow (families never span windows); run with "
                "engine=host for whole-genome trim-free semantics", S)
            return _search_duplications_sharded(strands_files, settings, S,
                                                "cuda", device, profile)
        eng.ensure_index(to_process)
        prof["index_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        families = _protosds(eng.run_chunks(to_process), to_process,
                             settings)
    else:
        se = SearchEngine(strand, settings, trim, engine="host",
                          index_cache=index_cache)
        prof["index_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        families = _host_families(se, to_process, settings)
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
    Host windows run on a thread pool; device windows in turn, each one's
    host tail overlapping the next one's device phase
    (:func:`_run_cuda_windows`)."""
    prof = profile if profile is not None else {}
    t0 = time.time()
    _, to_process, strand = prepare_data(
        strands_files, settings.skip_masked, None)
    windows = plan_windows(int(len(strand.data)) - 1, shards)
    prof["prepare_s"] = round(time.time() - t0, 3)

    t0 = time.time()
    if engine == "cuda":
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


def _window_tail(events, to_process, strand, settings) -> RunResult:
    """Host phase of one device window: chain its chunks' events, then
    the post-processing Step chain."""
    families = _protosds(chain_chunk_events(events, settings), to_process,
                         settings)
    return _finalize_result(families, strand, settings)


def _run_cuda_windows(windows, to_process, strand, settings, device
                      ) -> list:
    """The device windows of a sharded run, results in window order
    (pipeline.py:288-355). One route serves every window: it is chosen
    for the first, largest window (:func:`_window_route`, the merge-join
    engine charged for the probe keys it holds across windows) before
    anything is allocated, so a run no route holds fails before any window
    runs. This thread runs each window's device phase (build, scans,
    downloads) in turn; one tail thread runs each window's host phase
    (:func:`_window_tail`) while the next window's device phase runs. The
    tail holds no device memory (the scans' outputs are already on the
    host), so no headroom check gates the overlap. A window's failure
    fails the run: nothing reruns a window or moves it to the host
    engine."""
    # the one-entry index cache cannot hold a window set: free it, and
    # build the windows uncached
    INDEX_CACHE.clear()
    n1 = int(len(strand.data))
    ws, we = windows[0]
    route = _window_route(n1, we - ws + 1, settings, device, resident=n1,
                          keys_held=True)
    codes = upload_codes(strand.data, device)  # once for every window
    extra = {}
    if route is DeviceWindowEngine:  # the probe keys, packed once
        extra["probe_cache"] = ProbeKeyCache()
    tails = []
    with ThreadPoolExecutor(max_workers=1) as tail_ex:
        for w in windows:
            s = dataclasses.replace(settings, trim=w)
            # the engine (and its index) is dropped before the next build
            events = route(strand, s, device, trim=w, cache=None,
                           codes=codes, **extra).scan_chunks(to_process)
            tails.append(tail_ex.submit(_window_tail, events, to_process,
                                        strand, s))
    return [t.result() for t in tails]
