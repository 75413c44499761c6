"""End-to-end search: prepare -> index -> scan + chain -> post -> result.

Counterpart of ``asgart_tpu.pipeline.search_duplications``
(asgart_tpu/pipeline.py:674-944) for its whole-genome, one-device branch
(no trim, shards or checkpoint). The host stages are the JAX package's own:
``prepare_data``, ``raw_families_to_protosds`` and ``_finalize_result``,
and ``SearchEngine`` for ``engine="host"``.

With ``engine="cuda"`` every input the port does not cover yet raises
``NotImplementedError`` naming its ROADMAP item; no input switches
engines on its own.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from asgart_tpu.fasta import prepare_data
from asgart_tpu.pipeline import (SearchEngine, _finalize_result,
                                 raw_families_to_protosds)
from asgart_tpu.structs import RunResult, RunSettings

from .device import cuda_device
from .device_engine import FusedEngine
from .fused_index import INDEX_CACHE, MAX_K, fused_fits

log = logging.getLogger("asgart")

ENGINES = ("host", "cuda")


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the cuda engine yet (ROADMAP {item}); "
        "use engine='host' or the asgart_tpu package")


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
    (``index_cache`` applies to it only). ``profile``: dict to fill with
    phase timings."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}")
    if not (1 <= settings.probe_size <= 10000):
        raise ValueError(
            f"probe_size {settings.probe_size} is out of range (1..10000)")
    if checkpoint is not None:
        raise _unsupported("--checkpoint", "A12")
    if shards > 1:
        raise _unsupported("--shards", "A8")
    if hosts > 1:
        raise _unsupported("--hosts", "A11")
    if engine == "cuda":
        if settings.trim is not None:
            raise _unsupported("--trim", "A8")
        if settings.probe_size > MAX_K:
            raise NotImplementedError(
                f"probe_size > {MAX_K} has no device route: the asgart_tpu "
                "package serves those probe sizes on its host engine; use "
                "engine='host'")
        if settings.probe_size < 2:
            raise NotImplementedError(
                "probe_size 1 gives a probe step of 0, which no engine of "
                "the asgart_tpu package runs either (ROADMAP F6)")
        device = device if device is not None else cuda_device()
    prof = profile if profile is not None else {}
    total = time.time()
    t0 = time.time()
    trim, to_process, strand = prepare_data(
        strands_files, settings.skip_masked, settings.trim)
    prof["prepare_s"] = round(time.time() - t0, 3)

    t0 = time.time()
    if engine == "cuda":
        if not fused_fits(len(strand.data), settings.probe_size, device,
                          INDEX_CACHE.reclaimable_bytes()):
            raise _unsupported(
                "a genome beyond one device's fused build", "A7/A8")
        eng = FusedEngine(strand, settings, device)
        eng.ensure_index(to_process)
        prof["index_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        raws = eng.run_chunks(to_process)
        families = []
        for (start, length), raw in zip(to_process, raws):
            families.extend(raw_families_to_protosds(raw, settings, start,
                                                     length))
    else:
        se = SearchEngine(strand, settings, trim, engine="host",
                          index_cache=index_cache)
        prof["index_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        workers = settings.threads_count or os.cpu_count() or 1
        families = []
        with ThreadPoolExecutor(max_workers=workers) as ex:
            for fams in ex.map(se.run_chunk, to_process):
                families.extend(fams)
    prof["scan_s"] = round(time.time() - t0, 3)

    t0 = time.time()
    result = _finalize_result(families, strand, settings)
    prof["post_s"] = round(time.time() - t0, 3)
    prof["total_s"] = round(time.time() - total, 3)
    log.info("%s processed in %.2fs", ", ".join(strands_files),
             time.time() - total)
    return result
