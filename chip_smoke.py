"""GPU smoke run of the PyTorch / CUDA port (asgart_tpu_torch) on one card.

    python3 chip_smoke.py              # the full run: 128 Mbp paths, then
                                       # the 3100 Mbp big-window genome
    python3 chip_smoke.py --mbp 4      # smaller 128 Mbp-stage genome
    python3 chip_smoke.py --big-mbp 0  # without the full-scale phase
    python3 chip_smoke.py --mbp 4 --repeats-mbp 4 --big-mbp 0  # quick

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from asgart_tpu_torch/csrc with nvcc;
3. runs eight paths on ``asgart_tpu_torch.synthetic.synthetic_genome``
   (the repo benchmark's genome, fixed seed) written as
   FASTA, all -RC: the whole genome at k = 20 (one-word keys) and k = 25
   (two-word keys); ``--shards 4`` at k = 20; one trim window in the
   middle of the genome at k = 25; with a ballast tensor on the card
   that leaves too little memory for the fused build, the merge-join
   window engine on the same middle window at k = 20 (``mj_trim``) and on
   the ``--shards 4`` windows (``mj_shards``, held to the shards path's
   host JSON; its checks on window 2); and, with
   ``pipeline.BIG_WINDOW_SPAN`` lowered to 0 (at 128 Mbp the probed text
   stays under int32 addressing, where the fused build drops out), the
   route past int32 addressing to the merge-join engine on the middle
   window (``big_trim``, held to mj_trim's host JSON) and on the
   ``--shards 4`` windows (``big_shards``, held to the shards path's). For
   each path:
   a. runs each kernel of the path and its plain PyTorch version on the
      card, on that path's arrays (KI on the strand's upload; the fused
      build of the genome, or of window 2 of the shards, or of the trim
      window, and its largest chunk's scan, a window's, fused or
      merge-join, with the rebased constants on its window-relative
      order; KE's sizing pass, KE with its sort (beside its library
      route, the key pass and ``torch.sort``) and KF on the first,
      largest tie round, KF's compacted still-tied entries, count and
      longest sub-run included; KA's probe-only mode
      with its own bound), requires
      equal outputs (tolerance 0: all integers), times
      both with CUDA events after a warm-up, and gives each kernel its
      bound (the larger of its bytes over the HBM rate and its integer
      operations over the non-tensor-core rate) and the time of one
      PyTorch call (for KI, the same ops with a gather for the LUT) that
      computes the same function, where one exists; times the key sort
      and the whole tie resolution with the kernels against the same
      rounds on their plain versions (then once more with the sizing
      pass, KE and KF held to their plain versions in every round, each
      round's route printed), and the host side of the codes upload (the
      2-bit pack against the ``CODE`` LUT and pinned copy it replaces);
   b. the sharded path measures each window's build peak per fused row;
      the merge-join paths each window's build peak per window row and its
      stage 1 and scans' peak per probe lane, against
      ``MJ_PEAK_BYTES_PER_ROW`` and ``MJ_BYTES_PER_LANE``;
   c. runs the host engine once, unless the path is held to another
      path's host JSON (the first run also builds the native chain
      library, which the timed runs then find built);
   d. drives the path through the user entry point
      ``asgart_tpu_torch.pipeline.search_duplications(engine="cuda")``
      twice (whole genome and trim: cold, then a device index cache hit;
      shards: two full runs, the windows are not cached), with every
      launch counter set to 0 just before and read just after; requires
      the JSON bytes of all three runs to be equal and every kernel of
      the path to have been launched (the merge-join trim paths' cache
      hits launch neither KA nor KH nor KH's directory; their shards
      paths pack the probe keys once a run and build one directory a
      window);
4. three ``--checkpoint`` paths on the table engine (:func:`run_table_path`):
   ``table`` (the 128 Mbp genome, k = 20), ``table_k25`` (the same genome,
   k = 25: two-word keys) and ``table_repeats`` (a ``--repeats-mbp``
   genome, default 64 Mbp, of :func:`repeat_genome`: more than a quarter of
   its direct 20-mers tied, so that at the default ``tied_cap`` full rounds
   run first), all -RC. Each kernel against its plain version on the path's
   arrays (KI; KA's doubled mode; the sort; KB with the N flag; KJ, the
   table form of KC's scatter writing the decimated planes, and three
   ``index_put_``; KK / KL on the first full round where one runs; KE / KF
   on the first subset round and KF on every round; KM over the decimated
   planes, and torch gathers with the masks; KD
   on the largest chunk), the step-by-step index against
   ``DeviceIndex.build`` and its peak per text row against
   ``TABLE_PEAK_BYTES_PER_ROW``; the host engine with a journal; then
   through ``search_duplications(engine="cuda", checkpoint=...)``: (a) the
   cold run, the path's main run, whose launches are reported and must
   cover every kernel of the path; (b) a rerun that restores every chunk and
   launches nothing; (c) a rerun with the journal's last record removed,
   which launches KM and KD once each (a sliced chunk: KM, KO once and KD
   once a slice); (d) on the 128 Mbp paths, a run without a journal (the
   fused build); every JSON byte-equal to the host engine's. Where a
   chunk's raw total reaches the slice budget (table_repeats' one chunk at
   the default 2^26), :func:`sliced_checks` on it: KO and KP against their
   plain versions, the plan (raw total, slices, the largest slice's raw
   total), the scan phase's peak sliced and unsliced, and the KP-merged
   buffer against one unsliced KD launch; its runs then launch KO, and its
   device-chain run KP;
5. ``big_whole``: a ``--big-mbp`` genome (default 3100 Mbp, the size of a
   whole human genome, GRCh38's ~3.1 Gbp; at 1100 Mbp and more the
   doubled text passes 2^31, at 2148 Mbp and more the strand too) of
   100 Mbp records made record by record from the seed, with one planted -RC
   pair whose copy lies past 2^31, -RC at k = 20, default settings,
   through ``search_duplications(engine="cuda")`` with no shards given:
   the planner must choose the merge-join engine's windows by itself.
   Each kernel against its plain version at offsets past 2^31 (KI on the
   whole strand; KA on the probe lanes of the chunks past 2^31 and the
   last window's keys past it, with probe-only mode's own bound; KB, KH
   and its key directory on 32 M-row slices of the last
   window, KC and KE/KF on the whole of it, KD on two chunks against the
   last window's rebased constants); each window's build and stage-1
   peaks against the merge-join fit; two runs with equal JSON, the
   planted pair found past 2^31 and every coordinate below n1;
   ``gapped``: the codes upload of a copy of the 128 Mbp genome and of the
   big-window genome with GRCh38's share of N in long runs
   (:func:`gapped_copy`): the strand is dense, so ``upload_codes`` counts
   exceptions part of the way and takes the ``CODE`` LUT; its host time
   against the LUT and pinned copy alone, and its codes against theirs;
6. ``whole_sliced`` (:func:`run_whole_sliced`, after the whole k = 20
   path): the same genome and settings with ``ASGART_DEVICE_SLICE_LANES``
   at a quarter of the largest chunk's raw total (at least four slices),
   :func:`sliced_checks` on that chunk, then one run on the host chain and
   one on the device chain, each held to the whole path's host JSON;
7. the device chain: ``ASGART_DEVICE_CHAIN=1`` set in the process for one
   more run each of the whole genome at k = 20 (after its path), mj_shards
   (behind a ballast of its own), table_repeats (cold, journaled) and
   big_whole (:func:`device_chain_run`): the JSON must be the path's host
   JSON (big_whole: its cold run's), KN and every kernel of the path
   launched, the host event chain never called; then on each run's
   largest chunk (:func:`kn_checks`) KN against ``native.chain_events``
   (both timed) and against its plain version on the bursts that emit
   rows and on the longest burst's first events, also with one arm and
   one output row (both retries), with its arms in global scratch, on
   the block path alone and with most bursts handed over to it; the
   burst count, the longest burst and its time per event printed;
8. the seed lookups of ``SearchEngine(engine="cuda")`` and ``--hosts``,
   on the 128 Mbp genome, -RC, each phase's seconds printed:
   ``seed_trim`` (:func:`run_seed_trim`): ``SearchEngine(strand,
   settings, trim, engine="cuda")`` built directly (the entry point that
   reaches ``DeviceSeedIndex``) on the mj_trim window at k = 20, every
   chunk, then ``_finalize_result``, held to mj_trim's host JSON, KQ the
   only kernel launched; KQ against its plain version and
   ``torch.searchsorted`` (with its key reads, counted by the kernel's
   counting instance, beside the JAX loop's halvings; its bound from its
   reads) and KS against its plain version and the host
   pack, on the largest chunk; ``seed_k21`` (:func:`run_seed_k21`): the
   whole genome at k = 21 behind a ballast that leaves too little memory
   for the fused build and the table, so the router takes the
   ``SearchEngine`` route with its position tables on the card: a run
   without a journal and a journaled one, each held to the host engine's
   JSON with KR the only kernel launched, then KR's two forms against their
   plain versions and ``ranges[x]`` on the largest chunk's ``x``;
   ``hosts`` (:func:`run_hosts`): the CLI with ``--shards 4 --hosts 2
   --engine cuda`` (worker processes sharing the card), held to the shards
   path's host JSON, with its wall and the workers' device memory;
9. the mesh engines on ``torch.distributed`` (``asgart_tpu_torch
   .distributed``), each phase's seconds printed: ``rank_trim``
   (:func:`run_rank_trim`): a one-rank NCCL group in this process and
   ``ASGART_RANK_SHARDED=1`` behind :func:`mj_ballast`, so that the router
   takes ``ShardedWindowEngine`` on the mj_trim window, cold and warm, held
   to mj_trim's host JSON with KA, KH, KT and KD launched, every
   ``all_reduce`` printed, and KT against its plain version on the largest
   chunk; ``rank_trim4`` (:func:`run_rank_trim4`): ``distributed.dryrun``
   with four gloo ranks sharing the card, the same window built on the
   host (``ASGART_RSH_HOST_BUILD=1``), the four JSONs identical and
   mj_trim's host JSON, each rank's launches, peak and collectives, then
   KT against its plain version on each of the four ranks' shards
   (:func:`kt_check`); and
   ``probe_mesh2`` (:func:`run_probe_mesh2`): two gloo ranks sharing the
   card on the whole genome at k = 20 (the table engine's probe-axis
   scan), held to the whole path's host JSON with KM and KD launched on
   each rank, each rank's lanes and every ``all_gather`` printed; then
   ``mesh_shards`` (:func:`run_mesh_shards`): 8 gloo ranks sharing the
   card at ``--shards 4`` (the windows x probes mesh (4, 2)), held to the
   shards path's host JSON with KA, KH, KD and KP launched on every rank,
   each rank's cell, window, lanes per chunk, collectives, peak and wall
   printed, then KA, KH, each cell's KD of window 2 and KP's merge of
   those cells against their plain versions (:func:`mesh_checks`);
   ``seq_shards3``
   (:func:`run_seq_shards3`): 3 gloo ranks at ``--shards 4``, the windows
   one after another on every rank, held to the same JSON;
   ``group_journal2`` (:func:`run_group_journal2`): 2 gloo ranks on the
   whole genome with ``--checkpoint`` (rank 0 writes), cold and resumed
   from the first chunk's record, held to the whole path's host JSON; then
   :func:`nccl_shared_card` prints how NCCL treats two ranks on one card;
10. prints a {"kernels": [...]} line (each kernel once per path, with the
   path's name and k; each row's ``ms`` the wrapper's call; KA's, KC's,
   KF's, KH's and its directory's, KI's, KJ's, KK's, KL's, KM's, KP's,
   KQ's, KR's and KT's rows also ``kernel_alone_ms`` and ``library_alone_ms``
   (null where no library call computes the function), the launches alone
   (:func:`kernel_ms`), and KQ's ``key_reads`` and ``jax_loop_probes``,
   counted by the kernel (``kernels.seed.equal_range_reads``), KH's
   ``key_reads`` and ``dir_reads``, counted by the kernel
   (``kernels.merge_join.mj_ranges_reads``), its bound from them, and
   beside each KH row its directory's (``mj_directory``) against its
   plain version, with ``with_flag_read_ms``, the wrapper and the read of
   its flag (:func:`kh_checks`);
   beside KP's rows ``merge_slices``' whole time is printed; KN's
   rows: its time, the plain time and the bound
   on the checked bursts, and beside them its chunk's events, bursts,
   native tests, one KN pass over the chunk and the host chain's time on
   the chunk); before each KD row, its masked windows' lengths by powers
   of two (:func:`window_histogram`) and the CUDA kernels of one call with
   their device times (:func:`kernel_profile`, ``torch.profiler``); the
   card again, and last {"ok": true, ...}.

Any failure raises before the last line; without CUDA it exits non-zero
and prints no result. Nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
REPS = 3
# KP's, KQ's and KR's rows: their wrappers and library calls take 0.01-3 ms
# and wait on the host at small sizes, where a mean of 3 calls swings 2-5x
FINE_REPS = 20
SLEEP_CYCLES = 50_000_000  # kernel_ms's busy-wait: ~25 ms at the H100's clock
SHARDS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12      # H100 SXM non-tensor-core rate (data sheet)
WHOLE = ("unpack_codes", "pack_keys", "group_bounds", "invert_fused",
         "tie_keys", "tie_refine", "scan_core")
# the merge-join window engine: KH and its key directory
MJ = WHOLE + ("mj_ranges", "mj_directory")
# the table engine (--checkpoint): its build, then KM and KD per chunk;
# full rounds (KK, KL) where the first tied count passes tied_cap
TABLE = ("unpack_codes", "pack_keys", "group_bounds", "invert_tables",
         "tie_keys", "tie_refine", "table_ranges", "scan_core")
FULL_ROUNDS = ("full_round_keys", "full_round_refine")
REPEATS_MBP = 64.0  # the repeat-dense genome of the table_repeats path
RECORD_BP = 100_000_000  # record length of the big-window genome
PLANT_BP = 20_000  # its planted -RC pair
N_RUN_BP = 30_000  # and its N runs (a chunk break: more than 5000)
SLICE_ROWS = 1 << 25  # rows of a full-scale check's slices (32 M)
# bursts' events on which KN meets its plain version (the plain version
# takes ~1 ms an event on whole k = 20's bursts: a large share of the
# default run's time; whole k = 20's bursts that emit rows and its short
# quiet ones hold under 38,000)
PLAIN_EVENTS = 40_000
PLAIN_BURST = 200  # the longest of the bursts that top them up
PLAIN_LONGEST = 4_000  # the longest of the others; the longest burst's cut
# A gapped assembly's N, in Mbp of GRCh38's 24 chromosomes (3088 Mbp laid
# end to end): roughly where its large gaps lie (the 1q12, 9q12, 16q11.2
# and Yq12 heterochromatin, the short arms of 13, 14, 15, 21 and 22, and
# smaller ones on 2, Yp and X), ~149.5 Mbp; with GAP_SMALL runs of
# GAP_SMALL_BP placed from the seed, ~151 Mbp, GRCh38's gap share (its
# 3.10 Gbp total against 2.95 Gbp ungapped). Scaled to the genome's size.
GRCH38_MBP = 3088.3
GAPS_MBP = ((125.0, 18.5), (341.0, 1.6), (1579.5, 16.6), (2077.05, 16.4),
            (2191.41, 18.0), (2298.45, 17.0), (2436.4, 8.5), (2777.47, 6.6),
            (2824.18, 11.6), (2933.0, 1.1), (3041.0, 3.0), (3057.6, 30.6))
GAP_SMALL, GAP_SMALL_BP = 150, 10_000


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of the device work ``fn()`` queues, without the
    host's time between its launches: the events and the ``reps`` calls
    are queued behind a busy-wait on the card (``torch.cuda._sleep``), so
    the card runs them back to back. ``fn`` must not wait for the card;
    raises if the busy-wait ended before the host had queued them all."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_in_time = not start.query()
    torch.cuda.synchronize()
    if not queued_in_time:
        raise AssertionError("kernel_ms: the card was idle before the "
                             "launches were queued (fn waits for the card, "
                             "or the busy-wait is too short)")
    return start.elapsed_time(end) / reps


def kernel_profile(fn, sessions: int = 3) -> str:
    """The CUDA kernels one call of ``fn`` runs, from ``torch.profiler``
    (after one warm-up call): each kernel's name, launches and device
    milliseconds, longest first. Late in this long process (after its
    NCCL and gloo ranks) a session can lose some or all of the call's
    kernels, CUDA-only sessions more often than sessions with CPU
    activity too (PERF.md §7): the line is the session, of ``sessions``,
    that recorded the most kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            if us > 0 and getattr(e, "device_type", None) != \
                    torch.autograd.DeviceType.CPU:
                rows.append((us, e.key, e.count))
        if len(rows) > len(best):
            best = rows
    if not best:
        return "no device time recorded"
    return "; ".join(f"{key[:60]} x{n} {us / 1e3:.4f} ms"
                     for us, key, n in sorted(best, reverse=True))


def window_histogram(lane_lo, lane_hi, lane_mask) -> str:
    """The masked lanes' window lengths ``lane_hi - lane_lo`` by powers of
    two: per bucket [2^(b-1), 2^b) (b = 0: empty windows), its lanes and
    the sa reads it holds; then the longest window."""
    import torch

    L = torch.where(lane_mask, lane_hi - lane_lo, 0).to(torch.int64)
    live = int(lane_mask.sum())
    ge = [(int((L >= (1 << b)).sum()), int(torch.where(
        L >= (1 << b), L, 0).sum())) for b in range(32)]
    parts = [f"0: {live - ge[0][0]} lanes"]
    for b in range(1, 32):
        nxt = ge[b] if b < 31 else (0, 0)
        lanes, reads = ge[b - 1][0] - nxt[0], ge[b - 1][1] - nxt[1]
        if lanes:
            parts.append(f"[{1 << (b - 1)}, {1 << b}): {lanes} lanes "
                         f"{reads} reads")
    return (f"{live} of {L.numel()} lanes masked in; " + ", ".join(parts)
            + f"; longest {int(L.max()) if L.numel() else 0}")


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching integer outputs, in slices of
    2^26 entries (no int64 copy of a genome-sized output); raises when the
    shapes differ (outputs of different sizes are not equal)."""
    import torch

    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), 1 << 26):
            d = (a[i:i + (1 << 26)].to(torch.int64)
                 - b[i:i + (1 << 26)].to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): the bytes
    the function must move (each input read once, each output written
    once) over the HBM rate, or its integer operations over the
    non-tensor-core rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ALU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def recorder(rows: list, path: str, k: int):
    """``record(name, src, replaces, err, ms, plain_ms, shape, nbytes, ops,
    library_ms=None, alone=None)``: prints a kernel's line, raises if it
    disagrees with its plain version, and appends its row to ``rows``
    (``ms`` is the wrapper's call; ``alone``, where given, the kernel's
    launches alone and the library call's, :func:`kernel_ms`, as the row's
    ``kernel_alone_ms`` and ``library_alone_ms``)."""
    tag = f"{path} k={k}"

    def record(name, src, replaces, err, ms, plain_ms, shape, nbytes, ops,
               library_ms=None, alone=None):
        bound_ms, bound_by = bound(nbytes, ops)
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        k_alone = l_alone = ""
        if alone is not None:
            k_alone = f" (alone {alone[0]:.4f} ms)"
            if alone[1] is not None:
                l_alone = f" (alone {alone[1]:.4f} ms)"
        print(f"{tag} kernel {name}: max_abs_err={err} kernel {ms:.3f} ms"
              f"{k_alone}, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}: {nbytes:.0f} B, {ops:.0f} ops), library "
              f"{lib}{l_alone} at {shape}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {tag} (max_abs_err {err})")
        rows.append({"name": name, "path": path, "k": k, "route": "cuda",
                     "source": f"asgart_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
        if alone is not None:
            rows[-1]["kernel_alone_ms"], rows[-1]["library_alone_ms"] = alone

    record.rows, record.tag = rows, tag
    return record


def tie_checks(record, tag: str, sa, rank, tied, M: int, k: int, device,
               h: int | None = None):
    """KE's sizing pass, KE (with its sort, on the route the first round
    takes) and KF on the first tie round (the largest tied set; ``h``: its
    prefix length, k by default) against their plain versions, KF's
    compacted still-tied entries, their count and longest sub-run
    included; KE's row beside its library route (its key pass and
    ``torch.sort``); then the whole tie resolution with the kernels and
    with their plain versions in the same rounds, in turns (plain, kernel,
    kernel, plain), and once more with the sizing pass, KE and KF held to
    their plain versions in every round, each round's route printed, and
    the checks' seconds. The sizing pass gets a row where the resolution
    runs it (a tied set of at least ``ties.SIZING_MIN`` entries); else the
    first round takes the library route, and the pass only finds the
    largest group for KE's row. Returns the resolved ``sa``."""
    import torch

    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.kernels import tie_groups, tie_keys, tie_refine
    from asgart_tpu_torch.kernels.ties import (TIE_SORT_CAP,
                                               tie_groups_plain,
                                               tie_keys_plain,
                                               tie_refine_plain)

    t_checks = time.time()
    # KF writes sa and rank in place, so each side gets its own copies (KF
    # reads neither, so repeated calls write the same values)
    slots = torch.nonzero(tied).flatten()
    n_tied = slots.numel()
    sized = n_tied >= ties_mod.SIZING_MIN
    if n_tied == 0:
        raise AssertionError(f"no tied rows on {tag}: KE/KF unchecked")
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(torch.int32)
    h = min(k if h is None else h, M)
    big = [torch.zeros(1, dtype=torch.int32, device=device) for _ in "kp"]
    kg = lambda: tie_groups(prims, big[0])  # noqa: E731
    pg = lambda: tie_groups_plain(prims, big[1])  # noqa: E731
    kg()
    pg()
    if max_abs_err(big[:1], big[1:]) != 0:
        raise AssertionError(f"KE's sizing pass differs from its plain "
                             f"version on {tag}")
    if sized:
        record("tie_groups", "ties.cu", "asgart_tpu/device_index.py:807 "
               "(routes the first round; no JAX counterpart)",
               max_abs_err(big[:1], big[1:]), cuda_ms(kg, FINE_REPS),
               cuda_ms(pg), f"{n_tied} tied entries, largest group "
               f"{int(big[0])}", 4 * n_tied + 4, n_tied,
               alone=(kernel_ms(kg, FINE_REPS), None))
    largest = int(big[0])
    route = "kernel" if sized and largest <= TIE_SORT_CAP else "library"
    bad_k = torch.zeros(1, dtype=torch.int32, device=device)
    bad_p = torch.zeros(1, dtype=torch.int32, device=device)
    # the round as routed, held to the plain version
    skey, order = tie_keys(ps, prims, rank, h, bad_k,
                           largest if sized else None)
    err = max_abs_err((skey, order, bad_k),
                      (*tie_keys_plain(ps, prims, rank, h, bad_p), bad_p))
    # the kernel's own sort on the round's entries in groups within its
    # capacity (all of them where the round takes the kernel's route)
    kps, kprims, klargest, within = ps, prims, largest, ""
    if largest > TIE_SORT_CAP:
        start = torch.ones(n_tied, dtype=torch.bool, device=device)
        start[1:] = prims[1:] != prims[:-1]
        at = torch.nonzero(start).flatten()
        size = torch.diff(at, append=at.new_tensor([n_tied]))
        keep = (size <= TIE_SORT_CAP)[torch.cumsum(start, 0) - 1]
        kps, kprims = ps[keep], prims[keep]
        klargest = int(size[size <= TIE_SORT_CAP].max()) if kps.numel() \
            else 0
        within = (f"; the kernel timed on its {kps.numel()} entries in "
                  f"groups of at most {TIE_SORT_CAP}")
    m_k = kps.numel()
    if m_k:
        ke = lambda: tie_keys(kps, kprims, rank, h, bad_k,  # noqa: E731
                              klargest)
        pe = lambda: tie_keys_plain(kps, kprims, rank, h, bad_p)  # noqa
        lib = lambda: tie_keys(kps, kprims, rank, h, bad_k)  # noqa: E731
        err = max(err, max_abs_err((*ke(), bad_k), (*pe(), bad_p)))
    else:  # no group within the capacity: the route's call alone
        ke = lib = lambda: tie_keys(ps, prims, rank, h, bad_k)  # noqa
        pe = lambda: tie_keys_plain(ps, prims, rank, h, bad_p)  # noqa
        m_k, within = n_tied, "; no group within the capacity"
    # KE's bytes: ps and prims in order (8), the rank gather (4), skey and
    # order written (16) an entry
    record("tie_keys", "ties.cu", "asgart_tpu/device_index.py:696 (:728)",
           err, cuda_ms(ke, FINE_REPS), cuda_ms(pe),
           f"{n_tied} tied entries, largest group {largest}, {route} route"
           f"{'' if sized else ' (unsized)'}{within}; library: KE's key "
           "pass + torch.sort(stable=True)",
           28 * m_k, 8 * m_k, cuda_ms(lib, FINE_REPS),
           alone=(kernel_ms(ke, FINE_REPS), kernel_ms(lib, FINE_REPS)))
    ke_row = record.rows[-1]
    del kps, kprims

    errs, ke_errs, routes = [], [], []

    def checked_refine(skey, order, slots, ps, sa_k, rank_k, cnt_k):
        """KF, held to its plain version on copies of ``sa_k`` and
        ``rank_k`` taken before it (its max_abs_err in ``errs``): sa, rank,
        the count, the longest sub-run and the compacted entries."""
        sa_p, rank_p = sa_k.clone(), rank_k.clone()
        cnt_p = torch.zeros_like(cnt_k)
        want = tie_refine_plain(skey, order, slots, ps, sa_p, rank_p, cnt_p)
        got = tie_refine(skey, order, slots, ps, sa_k, rank_k, cnt_k)
        m = int(cnt_p[0])
        errs.append(max_abs_err(
            (cnt_k, sa_k, rank_k, *(t[:m] for t in got)),
            (cnt_p, sa_p, rank_p, *(t[:m] for t in want))))
        return got

    def checked_keys(ps, prims, rank, h, bad, largest=None):
        """KE on the round's route, held to its plain version (its
        max_abs_err in ``ke_errs``, the route in ``routes``)."""
        got = tie_keys(ps, prims, rank, h, bad, largest)
        bad_p = torch.zeros_like(bad)
        ke_errs.append(max_abs_err((*got, bad),
                                   (*tie_keys_plain(ps, prims, rank, h,
                                                    bad_p), bad_p)))
        routes.append("K" if largest is not None and largest <= TIE_SORT_CAP
                      else "L")
        return got

    def checked_groups(prims, out):
        want = torch.zeros_like(out)
        tie_groups_plain(prims, want)
        tie_groups(prims, out)
        ke_errs.append(max_abs_err((out,), (want,)))

    sa_k, rank_k, sa_p, rank_p = sa.clone(), rank.clone(), sa.clone(), \
        rank.clone()
    cnt_k = torch.zeros(2, dtype=torch.int32, device=device)
    cnt_p = torch.zeros(2, dtype=torch.int32, device=device)
    checked_refine(skey, order, slots, ps, sa_k, rank_k, cnt_k)
    err, m = errs.pop(), int(cnt_k[0])
    kf = lambda: tie_refine(skey, order, slots, ps, sa_k,  # noqa: E731
                            rank_k, cnt_k)
    pf = lambda: tie_refine_plain(skey, order, slots, ps,  # noqa: E731
                                  sa_p, rank_p, cnt_p)
    # KF's bytes: skey and order (8 + 8), slots and the ps gather (4 + 4),
    # the sa and rank stores (4 + 4) an entry; 12 B a still-tied entry
    record("tie_refine", "ties.cu", "asgart_tpu/device_index.py:696", err,
           cuda_ms(kf), cuda_ms(pf), f"{n_tied} tied entries, {m} still "
           "tied (compacted)", 32 * n_tied + 12 * m, 20 * n_tied,
           alone=(kernel_ms(kf, FINE_REPS), None))
    kf_row = record.rows[-1]
    del skey, order, sa_k, rank_k, sa_p, rank_p, ps, prims, slots
    torch.cuda.empty_cache()
    kernels = (tie_groups, tie_keys, tie_refine)
    names = ("tie_groups", "tie_keys", "tie_refine")

    def resolve(fns):
        for name, f in zip(names, fns):
            setattr(ties_mod, name, f)
        try:
            out = sa.clone()
            r = rank.clone()
            torch.cuda.synchronize()
            t0 = time.time()
            ties_mod.resolve_ties(out, r, tied, M, k)
            torch.cuda.synchronize()
            return time.time() - t0, out
        finally:
            for name, f in zip(names, kernels):
                setattr(ties_mod, name, f)

    times = {True: [], False: []}
    finals = {}
    plain = (tie_groups_plain, tie_keys_plain, tie_refine_plain)
    for is_plain in (True, False, False, True):
        t, finals[is_plain] = resolve(plain if is_plain else kernels)
        times[is_plain].append(t)
    if not torch.equal(finals[True], finals[False]):
        raise AssertionError(f"tie resolution with the kernels differs from "
                             f"its plain rounds on {tag}")
    # every round's kernels against their plain versions (the launches of
    # this run are checks)
    t, out = resolve((checked_groups, checked_keys, checked_refine))
    if max(errs + ke_errs) != 0 or not torch.equal(out, finals[False]):
        raise AssertionError(f"a kernel differs from its plain version in a "
                             f"tie round on {tag} (max_abs_err KF "
                             f"{max(errs)}, KE {max(ke_errs)})")
    kf_row["max_abs_err"] = max(err, *errs)
    ke_row["max_abs_err"] = max(ke_row["max_abs_err"], *ke_errs)
    print(f"{tag} tie resolution of {n_tied} tied rows: kernels "
          f"{' / '.join(f'{t:.4f}' for t in times[False])} s, plain rounds "
          f"{' / '.join(f'{t:.4f}' for t in times[True])} s (host clock + "
          f"sync); {'the sizing pass, ' if sized else 'no sizing pass; '}"
          f"KE and KF held to their plain versions in "
          f"each of its {len(errs)} rounds: max_abs_err 0; routes by round "
          f"(K: KE's sort, L: the key pass and the library's sort) "
          f"{''.join(routes)}; the tie checks took "
          f"{time.time() - t_checks:.1f} s", flush=True)
    return finals[False]


def ki_check(record, tag: str, strand_data, device):
    """The host side of the codes upload: the 2-bit pack with its pinned
    copy against the ``CODE`` LUT with its pinned copy (host clock around
    work that ends in a synchronize); then KI against its plain version
    and the library ops (shift, mask, a LUT gather, ``index_put_``) on the
    uploaded packing, and its output against the LUT's codes. Returns the
    codes on the card."""
    import torch

    from asgart_tpu_torch.codes import pack_codes
    from asgart_tpu_torch.index import CODE
    from asgart_tpu_torch.kernels import unpack_codes
    from asgart_tpu_torch.kernels.codes import unpack_codes_plain

    n1 = len(strand_data)
    t0 = time.time()
    packed = pack_codes(strand_data)
    t_pack = time.time() - t0
    if packed is None:
        raise AssertionError(f"{tag}: the strand's exceptions are dense, so "
                             "nothing is packed and KI is unchecked")
    t0 = time.time()
    p, e_pos, e_code = (torch.from_numpy(a).pin_memory().to(
        device, non_blocking=True) for a in packed)
    torch.cuda.synchronize()
    t_copy = time.time() - t0
    del packed
    t0 = time.time()
    lut = CODE[strand_data]
    t_lut = time.time() - t0
    t0 = time.time()
    want = torch.from_numpy(lut).pin_memory().to(device, non_blocking=True)
    torch.cuda.synchronize()
    t_lut_copy = time.time() - t0
    del lut
    n_exc = e_pos.numel()
    print(f"{tag} host side of the codes upload (host clock, n1={n1}, "
          f"{n_exc} exceptions): 2-bit pack {t_pack:.3f} s + pinned copy "
          f"{t_copy:.3f} s = {t_pack + t_copy:.3f} s; CODE LUT {t_lut:.3f} "
          f"s + pinned copy {t_lut_copy:.3f} s = {t_lut + t_lut_copy:.3f} s",
          flush=True)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=device)
    lut4 = torch.tensor([1, 2, 3, 5], dtype=torch.uint8, device=device)

    def li():
        two = ((p[None, :] >> shifts[:, None]) & 3).reshape(-1)[:n1]
        return lut4[two.long()].index_put_((e_pos,), e_code)

    ki = lambda: unpack_codes(p, e_pos, e_code, n1)  # noqa: E731
    pi = lambda: unpack_codes_plain(p, e_pos, e_code, n1)  # noqa: E731
    codes = ki()
    err = max_abs_err((codes,), (pi(),))
    if not torch.equal(codes, want):
        raise AssertionError(f"KI's codes differ from CODE[strand] on {tag}")
    del want
    n4 = p.numel()
    record("unpack_codes", "codes.cu", "asgart_tpu/device_index.py:98", err,
           cuda_ms(ki), cuda_ms(pi),
           f"n1={n1}, n4 % 4 = {n4 % 4}, {n_exc} exceptions",
           n4 + n1 + 10 * n_exc, 4 * n1, library_ms=cuda_ms(li),
           alone=(kernel_ms(ki, FINE_REPS), None))
    torch.cuda.empty_cache()
    return codes


def gapped_copy(data):
    """A copy of the strand ``data`` with N where a gapped assembly has it
    (``GAPS_MBP`` scaled to its size, and ``GAP_SMALL`` runs of
    ``GAP_SMALL_BP`` scaled, placed from the seed). Returns (copy, the
    number of N written)."""
    import numpy as np

    n = len(data)
    g = data.copy()
    scale = n / (GRCH38_MBP * 1e6)
    small = max(1, int(GAP_SMALL_BP * scale))
    rng = np.random.default_rng([SEED, 38])
    runs = [(int(a * 1e6 * scale), int(ln * 1e6 * scale))
            for a, ln in GAPS_MBP]
    runs += [(int(a), small) for a in rng.integers(0, n - small, GAP_SMALL)]
    for a, ln in runs:
        g[a:a + ln] = ord("N")
    return g, int(np.count_nonzero(g == ord("N")))


def gapped_upload_check(tag: str, data, device) -> None:
    """The codes upload of a gapped copy of ``data`` (:func:`gapped_copy`):
    ``upload_codes`` must decline the pack (KI not launched) and give the
    ``CODE`` LUT's codes. Host clock around work that ends in a
    synchronize, in turns (LUT + pinned copy, upload_codes, upload_codes,
    LUT + pinned copy), and the declining exception count alone."""
    import torch

    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch.codes import exception_positions, upload_codes
    from asgart_tpu_torch.index import CODE

    g, n_n = gapped_copy(data)
    n1 = len(g)

    def lut():
        return torch.from_numpy(CODE[g]).pin_memory().to(device,
                                                         non_blocking=True)

    times = {"lut": [], "upload": []}
    out = {}
    before = kmod.launch_counts()["unpack_codes"]
    for name in ("lut", "upload", "upload", "lut"):
        out.pop(name, None)
        torch.cuda.empty_cache()
        t0 = time.time()
        out[name] = lut() if name == "lut" else upload_codes(g, device)
        torch.cuda.synchronize()
        times[name].append(time.time() - t0)
    if kmod.launch_counts()["unpack_codes"] != before:
        raise AssertionError(f"{tag} gapped: KI launched on a dense strand")
    if not torch.equal(out["lut"], out["upload"]):
        raise AssertionError(f"{tag} gapped: upload_codes differs from the "
                             "CODE LUT")
    del out
    t0 = time.time()
    if exception_positions(g) is not None:
        raise AssertionError(f"{tag} gapped: the strand was not declined")
    t_count = time.time() - t0
    print(f"{tag} gapped upload (host clock, n1={n1}, {n_n} N = "
          f"{100 * n_n / n1:.2f}%): upload_codes (declined pack, then the "
          f"LUT) {' / '.join(f'{t:.3f}' for t in times['upload'])} s, "
          f"CODE LUT + pinned copy alone "
          f"{' / '.join(f'{t:.3f}' for t in times['lut'])} s; the "
          f"declining exception count alone {t_count:.3f} s", flush=True)
    del g
    torch.cuda.empty_cache()


def kd_check(record, settings, specs, lane_off, lane_lo, lane_hi, lane_mask,
             sa, bases=None, chunk=None, part=None,
             replaces: str | None = None) -> None:
    """KD on one chunk's lanes (``chunk``, an index of ``specs``; the
    largest by default), as the engines call it: with the filter
    constants ``bases(chunk_start, chunk_len)``, the fused ones by
    default; ``part(n_lanes)`` = (a, b): only lanes [a, b) of the chunk,
    with j0 = a (a mesh cell's). Returns KD's result."""
    import torch

    from asgart_tpu_torch.kernels import scan_core
    from asgart_tpu_torch.kernels.scan_core import (fused_bases,
                                                    scan_core_plain)

    s = settings
    c = max(range(len(specs)), key=lambda i: specs[i][2]) \
        if chunk is None else chunk
    cs, cl, nc = specs[c]
    a, b = (0, nc) if part is None else part(nc)
    nc = b - a
    lanes = slice(lane_off[c] + a, lane_off[c] + b)
    consts = (bases or fused_bases)(cs, cl)
    args = (lane_lo[lanes], lane_hi[lanes], lane_mask[lanes], sa, *consts,
            s.max_cardinality, a, s.probe_size, s.reverse)
    kd = lambda: scan_core(*args)  # noqa: E731
    pd = lambda: scan_core_plain(*args)  # noqa: E731
    got, want = kd(), pd()
    if (got.n_events, got.total_kept) != (want.n_events, want.total_kept):
        raise AssertionError("scan_core output sizes differ: "
                             f"{(got.n_events, got.total_kept)} vs "
                             f"{(want.n_events, want.total_kept)}")
    err = max_abs_err((got.flat,), (want.flat,))
    reads = int(torch.where(lane_mask[lanes], lane_hi[lanes] - lane_lo[lanes],
                            0).sum())  # the sa entries this data needs
    tag = f"{record.tag} chunk ({cs}, {cl})"
    print(f"{tag} KD window lengths: "
          f"{window_histogram(*args[:3])}", flush=True)
    print(f"{tag} KD profile of one scan_core call: {kernel_profile(kd)}",
          flush=True)
    record("scan_core", "scan_core.cu", replaces or (
           "asgart_tpu/device_engine.py:249" if bases is None else
           "asgart_tpu/device_engine.py:665 (via :249)"), err, cuda_ms(kd),
           cuda_ms(pd), f"chunk ({cs}, {cl}): {nc} lanes from lane {a}, "
           f"constants {consts}, {got.n_events} events, {got.total_kept} "
           "matches",
           9 * nc + 4 * reads + 4 * got.flat.numel(), 8 * reads + 20 * nc)
    return got


def sliced_checks(record, tag: str, settings, chunk, lanes, sa,
                  consts) -> list:
    """The sliced dispatch of one chunk (``chunk`` = (start, len), its
    ``lanes`` = (lane_lo, lane_hi, lane_mask) views, KD's constants
    ``consts``) at the slice budget in force (``ASGART_DEVICE_SLICE_LANES``,
    which must slice it): KO against its plain version; the plan (raw
    total, slices, the largest slice's raw total); the scan phase's peak on
    the host chain (``device_engine.host_events``: each slice scanned,
    copied and let go before the next) against each slice's scan alone
    and one unsliced KD launch over the same lanes; the host merge and the
    KP-merged buffer (``merge_slices``, the device chain's) against the
    unsliced outputs; KP against its plain version and ``torch.take``.
    Returns the plan."""
    import numpy as np
    import torch

    from asgart_tpu_torch import device_engine as de
    from asgart_tpu_torch.host_helpers import SLICE_GRAN
    from asgart_tpu_torch.kernels import gather_flat, granule_totals
    from asgart_tpu_torch.kernels.scan_core import scan_core
    from asgart_tpu_torch.kernels.slices import (gather_flat_plain,
                                                 granule_totals_plain)
    from asgart_tpu_torch.window_index import WindowRanges

    s = settings
    lo, hi, mask = lanes
    n = lo.numel()
    ko = lambda: granule_totals(lo, hi, mask, SLICE_GRAN)  # noqa: E731
    po = lambda: granule_totals_plain(lo, hi, mask, SLICE_GRAN)  # noqa: E731
    gt = ko()
    err = max_abs_err((gt,), (po(),))
    record("granule_totals", "slices.cu",
           "asgart_tpu/device_engine.py:589 (+ :167)", err,
           cuda_ms(ko, FINE_REPS), cuda_ms(po), f"chunk {chunk}: {n} lanes, "
           f"{gt.numel()} granules of {SLICE_GRAN}", 9 * n + 8 * gt.numel(),
           2 * n, alone=(kernel_ms(ko, FINE_REPS), None))
    total = int(gt.sum())
    ranges = WindowRanges(lane_lo=lo, lane_hi=hi, lane_mask=mask,
                          specs=((*chunk, n),), offs={chunk: (0, total)})

    def sliced():
        (res,) = de.scan_lanes(s, ranges, sa, [chunk], lambda cs, cl: consts)
        if not isinstance(res, de.Sliced):
            raise AssertionError(f"{tag}: chunk {chunk} (raw total {total}) "
                                 "was not sliced")
        return res

    plan = sliced().plan
    big = max(plan, key=lambda p: p[2])
    print(f"{tag} sliced chunk {chunk}: raw total {total} (budget "
          f"{de._slice_budget()}), {len(plan)} slices, the largest slice's "
          f"raw total {big[2]:.0f} ({big[1]} lanes from lane {big[0]})",
          flush=True)

    def peak(fn):  # (fn's result, its peak above what it found allocated)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - held

    args = (s.max_cardinality, s.probe_size, s.reverse)
    alone = []
    for lane0, nl, _ in plan:
        view = (lo[lane0: lane0 + nl], hi[lane0: lane0 + nl],
                mask[lane0: lane0 + nl])
        alone.append(peak(lambda: scan_core(
            *view, sa, *consts, args[0], lane0, *args[1:]).to_host())[1])
    host, host_peak = peak(lambda: de.host_events(sliced()))
    one, one_peak = peak(lambda: scan_core(lo, hi, mask, sa, *consts,
                                           args[0], 0, *args[1:]))
    print(f"{tag} scan phase peak on the host chain: sliced {host_peak} B "
          f"(each slice alone at most {max(alone)} B) against one unsliced "
          f"KD launch's {one_peak} B ({one.n_events} events, "
          f"{one.total_kept} matches: {4 * one.flat.numel()} B of outputs)",
          flush=True)
    if host_peak > max(alone) + (1 << 20):
        raise AssertionError(f"{tag}: the sliced scan held more than one "
                             "slice at a time")
    want = de.host_events(one)  # None: no event
    if (host is None) != (want is None) or host is not None and not (
            all(np.array_equal(a, b) for a, b in zip(host[:2], want[:2]))
            and host[2] == want[2]):
        raise AssertionError(f"{tag}: the sliced host events differ from "
                             "the unsliced scan's")
    parts, dc_peak = peak(lambda: list(sliced()))
    merged, merge_peak = peak(lambda: de.merge_slices(parts))
    err = max_abs_err((merged.flat,), (one.flat,))
    print(f"{tag} the KP-merged buffer of {len(parts)} slices against one "
          f"unsliced KD launch: max_abs_err={err}; device-chain scan phase "
          f"peak: slices {dc_peak} B, then the merge {merge_peak} B above "
          "them", flush=True)
    if err or (merged.n_events, merged.total_kept) != (one.n_events,
                                                       one.total_kept):
        raise AssertionError(f"{tag}: the KP-merged buffer differs from the "
                             "unsliced scan's")
    del merged, one
    idx = de.merged_index(parts)
    srcs = [p.flat for p in parts]
    kp = lambda: gather_flat(srcs, idx)  # noqa: E731
    pp = lambda: gather_flat_plain(srcs, idx)  # noqa: E731
    err = max_abs_err((kp(),), (pp(),))
    src = torch.cat(srcs)
    lib = lambda: torch.take(src, idx)  # noqa: E731
    if not torch.equal(lib(), kp()):
        raise AssertionError(f"torch.take differs from KP on {tag}")
    m = idx.numel()
    record("gather_flat", "slices.cu", "asgart_tpu/device_engine.py:1112",
           err, cuda_ms(kp, FINE_REPS), cuda_ms(pp, FINE_REPS),
           f"{m} entries from {len(srcs)} slices' buffers ({src.numel()} "
           "int32)", 12 * m + 4 * src.numel(), m,
           library_ms=cuda_ms(lib, FINE_REPS),
           alone=(kernel_ms(kp, FINE_REPS), kernel_ms(lib, FINE_REPS)))
    merge_ms(tag, parts)
    del parts, srcs, src, idx
    torch.cuda.empty_cache()
    return plan


def merge_ms(tag: str, parts) -> None:
    """Prints ``merge_slices``' whole time on ``parts``: ``merged_index``
    (an ``arange`` and its 4 S + 1 shifted runs), KP and the aging carry's
    upload and add."""
    from asgart_tpu_torch.device_engine import merge_slices

    print(f"{tag} merge_slices of {len(parts)} parts: "
          f"{cuda_ms(lambda: merge_slices(parts), FINE_REPS):.3f} ms "
          "(merged_index, KP, the carry)", flush=True)


def json_text(result) -> str:
    from asgart_tpu_torch.exporters import JSONExporter

    buf = io.StringIO()
    JSONExporter().save(result, buf)
    return buf.getvalue()


def kernel_checks(fa: str, path: str, settings, device,
                  trim=None) -> tuple[list, int]:
    """Each kernel of a path against its plain version at the path's
    shapes: the whole genome's fused build, or the window ``trim``'s.
    Returns (kernel rows, fused rows M)."""
    from asgart_tpu_torch.device_engine import chunk_specs, rebased_bases
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import fused_layout, sort_keys
    from asgart_tpu_torch.host_helpers import _strand_fingerprint
    from asgart_tpu_torch.kernels import group_bounds, invert_fused, pack_keys
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)

    s = settings
    k = s.probe_size
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    ws = 0 if trim is None else trim[0]
    W0 = n1 if trim is None else trim[1] - trim[0] + 1
    W, total, lane_off = fused_layout(W0, specs)
    M = W + total
    rows = []
    tag = f"{path} k={k}"
    record = recorder(rows, path, k)

    t0 = time.time()
    _strand_fingerprint(strand.data)
    print(f"{tag} host side of a build: strand fingerprint "
          f"{time.time() - t0:.3f} s (host clock)")
    codes = ki_check(record, tag, strand.data, device)
    tabs = chunk_tables(specs, n1, k, s.reverse, s.complement)
    ka = lambda: pack_keys(codes, specs, k, s.reverse, s.complement, W,  # noqa: E731
                           total, ws)
    kp = lambda: pack_keys_plain(codes, *tabs, k, s.reverse,  # noqa: E731
                                 s.complement, W, total, ws)
    keys, lane_mask = ka()
    want_keys, want_mask = kp()
    err = max_abs_err((*keys, lane_mask), (*want_keys, want_mask))
    del want_keys, want_mask
    words = len(keys)
    kwb = 8 if words == 1 else 12  # key bytes per row
    if trim is not None:
        replaces = "asgart_tpu/device_index.py:1288"
    elif words == 1:
        replaces = "asgart_tpu/device_engine.py:904"
    else:
        replaces = "asgart_tpu/device_engine.py:761"
    record("pack_keys", "pack_keys.cu", replaces, err,
           cuda_ms(ka, FINE_REPS), cuda_ms(kp),
           f"M={M}, W={W}, ws={ws}, {words} key words",
           n1 + M * kwb + total, M * (4 * k + 8),
           alone=(kernel_ms(ka, FINE_REPS), None))
    del codes

    ms = cuda_ms(lambda: sort_keys([w.clone() for w in keys]))
    sort_bound, sort_by = bound(M * (2 * kwb + 4), 0)
    skeys, sa = sort_keys(keys)
    print(f"{tag} stable sort of {M} rows by {words} key word(s) "
          f"(fused_index.sort_keys, torch.sort, {words} launch(es) per "
          f"build): {ms:.3f} ms (CUDA events, incl. a copy of the keys), "
          f"bound {sort_bound:.3f} ms ({sort_by})", flush=True)

    kb = lambda: group_bounds(skeys, sa, W)  # noqa: E731
    pb = lambda: group_bounds_plain(skeys, sa, W)  # noqa: E731
    run_lo, run_hi, tied = kb()
    err = max_abs_err((run_lo, run_hi, tied), pb())
    record("group_bounds", "group_bounds.cu",
           "asgart_tpu/device_index.py:352", err, cuda_ms(kb), cuda_ms(pb),
           f"M={M}, {words} key words", M * (kwb + 4 + 9), M * 20)
    del skeys

    kc = lambda: invert_fused(sa, run_lo, run_hi, lane_mask, W,  # noqa: E731
                              lane_off)
    pc = lambda: invert_fused_plain(sa, run_lo, run_hi,  # noqa: E731
                                    lane_mask, W, lane_off)
    rank, lane_lo, lane_hi, totals = kc()
    err = max_abs_err((rank, lane_lo, lane_hi, totals), pc())
    record("invert_fused", "invert.cu", "asgart_tpu/device_index.py:1519",
           err, cuda_ms(kc, FINE_REPS), cuda_ms(pc), f"M={M}, {total} lanes "
           f"in {len(lane_off) - 1} chunks",
           12 * M + total + 4 * W + 8 * total, 10 * M,
           alone=(kernel_ms(kc, FINE_REPS), None))
    del run_lo, run_hi

    sa = tie_checks(record, tag, sa, rank, tied, M, k, device)
    del rank, tied
    # a window's suffix order keeps window positions: the rebased constants,
    # as FusedEngine scans it
    kd_check(record, s, specs, lane_off, lane_lo, lane_hi, lane_mask, sa,
             bases=None if trim is None else
             lambda cs, cl: rebased_bases(cs, cl, ws, W0),
             replaces=None if trim is None else
             "asgart_tpu/device_engine.py:249 (window, rebased)")
    return rows, M


def kh_checks(record, tag: str, skey, k: int, pkey, pmask, lane_off,
              replaces: str, shape: str):
    """KH's key directory of the sorted keys ``skey`` (:func:`mj_directory
    <asgart_tpu_torch.kernels.merge_join.mj_directory>`, as the window
    index builds it) against its plain version, then KH searching from it
    against its plain version and two ``torch.searchsorted`` calls: the
    wrapper and the library over ``FINE_REPS`` calls, each alone too
    (:func:`kernel_ms`), and the bound from the key and directory reads
    the kernel counts (``mj_ranges_reads``), each capped at the distinct
    bytes they can touch: 8 B a key read, at most the window's 8 W, and
    4 B a directory read, at most its 2^bits + 1 words, beside 17 B a lane
    of keys, mask and ranges. Records both rows and returns KH's (lane_lo,
    lane_hi, totals)."""
    import torch

    from asgart_tpu_torch.kernels import mj_directory, mj_ranges
    from asgart_tpu_torch.kernels.merge_join import (mj_directory_plain,
                                                     mj_ranges_plain,
                                                     mj_ranges_reads)

    W, total = skey.numel(), pkey.numel()
    kd = lambda: mj_directory(skey, k)  # noqa: E731
    kf = lambda: mj_directory(skey, k).check()  # noqa: E731  (flag read)
    d = kf()
    pd = lambda: mj_directory_plain(skey, k, d.bits)  # noqa: E731
    err = max_abs_err((d.table,), (pd().table,))
    flag_ms = cuda_ms(kf, FINE_REPS)
    record("mj_directory", "merge_join.cu", f"{replaces} (the directory "
           "KH searches from)", err, cuda_ms(kd, FINE_REPS), cuda_ms(pd),
           f"{shape}: 2^{d.bits} buckets of {W} sorted keys; with its flag "
           f"read {flag_ms:.4f} ms", 8 * W + d.nbytes(),
           4 * W * max(1, (d.bits + 1) // 2),
           alone=(kernel_ms(kd, FINE_REPS), None))
    record.rows[-1]["with_flag_read_ms"] = flag_ms
    kh = lambda: mj_ranges(skey, pkey, pmask, lane_off, d)  # noqa: E731
    ph = lambda: mj_ranges_plain(skey, pkey, pmask, lane_off)  # noqa: E731
    got = kh()
    err = max_abs_err(got, ph())
    sk, pk = skey >> 1, pkey >> 1  # the flag-free keys
    ends = torch.tensor(lane_off[1:], device=skey.device) - 1

    def lh():  # the two searchsorted calls and the masked sums
        lo = torch.searchsorted(sk, pk, side="left")
        hi = torch.searchsorted(sk, pk, side="right")
        return torch.where(pmask, hi - lo, 0).cumsum(0)[ends]

    csum = lh()
    if not torch.equal(csum - torch.cat([csum.new_zeros(1), csum[:-1]]),
                       got[2]):
        raise AssertionError(f"torch.searchsorted totals differ from KH on "
                             f"{tag}")
    reads, dir_reads = mj_ranges_reads(skey, pkey, pmask, lane_off, d)
    n_masked = int(pmask.sum())
    record("mj_ranges", "merge_join.cu", replaces, err, cuda_ms(kh, FINE_REPS),
           cuda_ms(ph), f"{shape}: {total} lanes ({n_masked} masked in) "
           f"against W={W} from 2^{d.bits} buckets; {reads} key reads, "
           f"{dir_reads} directory reads (counted by the kernel)",
           17 * total + 8 * min(reads, W) + 4 * min(dir_reads, d.bits and
                                                    (1 << d.bits) + 1),
           4 * (reads + dir_reads),
           library_ms=cuda_ms(lh, FINE_REPS),
           alone=(kernel_ms(kh, FINE_REPS), kernel_ms(lh, FINE_REPS)))
    record.rows[-1]["key_reads"] = reads
    record.rows[-1]["dir_reads"] = dir_reads
    return got


def mj_kernel_checks(fa: str, path: str, settings, device, trim
                     ) -> tuple[list, int, int]:
    """Each kernel of the merge-join window engine against its plain
    version at the shapes of the window ``trim`` probed by the whole
    genome: KI, KA's window keys and probe-only mode (one row), the sort,
    KB, KC with no lanes, KE/KF, KH and KD on the largest chunk with the
    rebased constants on the window-relative order. Returns (kernel rows,
    W, probe lanes)."""
    import torch

    from asgart_tpu_torch.device_engine import chunk_specs, rebased_bases
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          pack_keys)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)

    s = settings
    k = s.probe_size
    rc = (s.reverse, s.complement)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    ws, we = trim
    W = we - ws + 1
    tabs = chunk_tables(specs, n1, k, *rc)
    lane_off = tabs[0]
    total = lane_off[-1]
    rows = []
    tag = f"{path} k={k}"
    record = recorder(rows, path, k)

    codes = ki_check(record, tag, strand.data, device)
    # KA, both sides of the join: the window's keys (no probe rows) and
    # the probe keys (no window rows); one row for the kernel
    kaw = lambda: pack_keys(codes, (), k, *rc, W, 0, ws)  # noqa: E731
    paw = lambda: pack_keys_plain(codes, [0], [], [], k, *rc, W, 0,  # noqa: E731
                                  ws)
    kap = lambda: pack_keys(codes, specs, k, *rc, 0, total)  # noqa: E731
    pap = lambda: pack_keys_plain(codes, *tabs, k, *rc, 0, total)  # noqa: E731
    (key,), _ = kaw()
    (pkey,), pmask = kap()
    err_w = max_abs_err((key,), paw()[0])
    want_key, want_mask = pap()
    err_p = max_abs_err((pkey, pmask), (*want_key, want_mask))
    del want_key, want_mask
    times = [cuda_ms(kaw, FINE_REPS), cuda_ms(paw), cuda_ms(kap, FINE_REPS),
             cuda_ms(pap)]
    alone = kernel_ms(kaw, FINE_REPS) + kernel_ms(kap, FINE_REPS)
    # probe-only mode's own bound: the strand's codes, 9 B per lane out
    p_bound, p_by = bound(n1 + 9 * total, total * (4 * k + 8))
    print(f"{tag} KA window keys (W={W}, ws={ws}): max_abs_err={err_w} "
          f"kernel {times[0]:.3f} ms, plain {times[1]:.3f} ms; probe-only "
          f"({total} lanes): max_abs_err={err_p} kernel {times[2]:.3f} ms, "
          f"plain {times[3]:.3f} ms, bound {p_bound:.4f} ms ({p_by})",
          flush=True)
    record("pack_keys", "pack_keys.cu",
           "asgart_tpu/device_engine.py:904 + asgart_tpu/device_index.py:269",
           max(err_w, err_p), times[0] + times[2], times[1] + times[3],
           f"W={W}, ws={ws} window keys + {total} probe keys",
           W + 8 * W + n1 + 9 * total, (W + total) * (4 * k + 8),
           alone=(alone, None))
    del codes

    ms = cuda_ms(lambda: sort_keys([key.clone()]))
    sort_bound, sort_by = bound(W * 20, 0)
    (skey,), sa = sort_keys([key])
    print(f"{tag} stable sort of the {W} window keys (torch.sort): "
          f"{ms:.3f} ms (CUDA events, incl. a copy of the keys), bound "
          f"{sort_bound:.3f} ms ({sort_by})", flush=True)

    kb = lambda: group_bounds([skey], sa, W)  # noqa: E731
    pb = lambda: group_bounds_plain([skey], sa, W)  # noqa: E731
    run_lo, run_hi, tied = kb()
    err = max_abs_err((run_lo, run_hi, tied), pb())
    record("group_bounds", "group_bounds.cu",
           "asgart_tpu/device_index.py:433", err, cuda_ms(kb), cuda_ms(pb),
           f"W={W}, every row direct", W * (8 + 4 + 9), W * 20)

    none = torch.zeros(0, dtype=torch.bool, device=device)
    kc = lambda: invert_fused(sa, run_lo, run_hi, none, W, [0])  # noqa: E731
    pc = lambda: invert_fused_plain(sa, run_lo, run_hi, none, W,  # noqa: E731
                                    [0])
    got = kc()
    rank = got[0]
    err = max_abs_err(got, pc())
    sa64 = sa.long()
    lib = torch.empty(W, dtype=torch.int32, device=device)
    lc = lambda: lib.index_put_((sa64,), run_lo)  # noqa: E731
    record("invert_fused", "invert.cu", "asgart_tpu/device_index.py:631",
           err, cuda_ms(kc, FINE_REPS), cuda_ms(pc), f"W={W}, no lanes",
           12 * W, W, library_ms=cuda_ms(lc, FINE_REPS),
           alone=(kernel_ms(kc, FINE_REPS), kernel_ms(lc, FINE_REPS)))
    if not torch.equal(lib, rank):
        raise AssertionError(f"index_put_ differs from KC on {tag}")
    del run_lo, run_hi, sa64, lib

    sa = tie_checks(record, tag, sa, rank, tied, W, k, device)
    del rank, tied

    lane_lo, lane_hi, _ = kh_checks(
        record, tag, skey, k, pkey, pmask, lane_off,
        "asgart_tpu/device_engine.py:788", f"W={W}")
    del skey, pkey

    kd_check(record, s, specs, lane_off, lane_lo, lane_hi, pmask, sa,
             lambda cs, cl: rebased_bases(cs, cl, ws, W))
    return rows, W, total


def mj_peaks(fa: str, settings, windows, device) -> float:
    """Each window's merge-join build alone, with the codes uploaded once
    beside it: its peak device bytes above what was allocated before it,
    per window row; then its stage 1 and scans (the engine over the built
    index): their peak above the index and codes, per probe lane; each
    against the fit's constants. Returns the largest build peak in bytes
    (codes included)."""
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import DeviceWindowEngine
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import (MJ_BYTES_PER_LANE,
                                              MJ_PEAK_BYTES_PER_ROW)
    from asgart_tpu_torch.window_index import DeviceWindowIndex

    s = settings
    k = s.probe_size
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    torch.cuda.empty_cache()
    codes = upload_codes(strand.data, device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    largest = 0
    for ws, we in windows:
        torch.cuda.reset_peak_memory_stats(device)
        idx = DeviceWindowIndex.build(strand.data, k, (ws, we), s.reverse,
                                      s.complement, device, codes)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        largest = max(largest, peak)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        eng = DeviceWindowEngine(strand, s, device, (ws, we), cache=None,
                                 index=idx, codes=codes)
        eng.scan_chunks(chunks)
        torch.cuda.synchronize()
        peak1 = torch.cuda.max_memory_allocated(device)
        lanes = sum(nc for (_, _, nc) in idx.stage1.specs)
        per_row, per_lane = (peak - base) / idx.W, (peak1 - held) / lanes
        print(f"mj k={k} window ({ws}, {we}): "
              f"build peak {peak - base} B above the {base} B resident = "
              f"{per_row:.2f} B per window row ({idx.W} rows; "
              f"MJ_PEAK_BYTES_PER_ROW = {MJ_PEAK_BYTES_PER_ROW}); stage 1 "
              f"and scans peak {peak1 - held} B above the {held} B of index "
              f"and codes = {per_lane:.2f} B per probe lane "
              f"({lanes} lanes; MJ_BYTES_PER_LANE = {MJ_BYTES_PER_LANE})",
              flush=True)
        if per_row > MJ_PEAK_BYTES_PER_ROW or per_lane > MJ_BYTES_PER_LANE:
            raise AssertionError(f"window ({ws}, {we}) peaks above the "
                                 "merge-join fit's constants")
        del eng, idx
    del codes
    torch.cuda.empty_cache()
    return largest


def window_peaks(fa: str, settings, windows, device) -> float:
    """Each window's fused build alone, as a sharded run builds it (the
    codes uploaded once beside it): its peak device bytes above what was
    allocated before it, per fused row. Returns the largest peak in
    bytes (codes included)."""
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import (PEAK_BYTES_PER_ROW,
                                              FusedIndex, projected_rows)
    from asgart_tpu_torch.kernels.pack_keys import key_words

    s = settings
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    torch.cuda.empty_cache()
    codes = upload_codes(strand.data, device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    largest = 0
    for ws, we in windows:
        torch.cuda.reset_peak_memory_stats(device)
        idx = FusedIndex.build(strand.data, s.probe_size, specs, s.reverse,
                               s.complement, device, trim=(ws, we),
                               codes=codes)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        M = int(idx.sa.numel())
        rows = projected_rows(n1, we - ws + 1, s.probe_size)
        projected = rows * PEAK_BYTES_PER_ROW[key_words(s.probe_size)] + n1
        print(f"shards k={s.probe_size} window ({ws}, {we}): build peak "
              f"{peak - base} B above the {base} B resident = "
              f"{(peak - base) / M:.2f} B per fused row ({M} rows); "
              f"fused_index.fits projects {projected} B ({rows} rows), "
              f"measured {peak} B in all", flush=True)
        largest = max(largest, peak)
        del idx
    del codes
    torch.cuda.empty_cache()
    return largest


def run_path(fa: str, n: int, device, path: str, settings, shards: int = 1,
             kernels=WHOLE, min_sds: int = 1) -> tuple[list, str]:
    """One path: the kernel checks, the host engine, then two runs through
    the user entry point; the JSON must hold at least ``min_sds``
    duplications. Returns the path's kernel rows with their main-path
    launch counts, and the host engine's JSON."""
    import torch

    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import plan_windows, search_duplications

    k = settings.probe_size
    tag = f"{path} k={k}"
    if shards > 1:
        windows = plan_windows(n, shards)
        rows, fused_rows = kernel_checks(fa, path, settings, device,
                                         trim=windows[2])
        largest = window_peaks(fa, settings, windows, device)
    else:
        rows, fused_rows = kernel_checks(fa, path, settings, device,
                                         trim=settings.trim)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t0 = time.time()
    host = json_text(search_duplications([fa], settings, engine="host",
                                         shards=shards))
    t_host = time.time() - t0

    # the main path, through the user entry point, from an empty cache
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    kmod.reset_launch_counts()
    runs = {}
    for tag2 in (("cold", "second") if shards > 1 else ("cold", "warm")):
        prof: dict = {}
        t0 = time.time()
        res = search_duplications([fa], settings, engine="cuda",
                                  device=device, shards=shards, profile=prof)
        torch.cuda.synchronize()
        runs[tag2] = (time.time() - t0, json_text(res), prof)
        if tag2 == "cold":
            peak = torch.cuda.max_memory_allocated(device)
    counts = kmod.launch_counts()

    for tag2, (t, text, prof) in runs.items():
        print(f"{tag} cuda {tag2}: {t:.3f} s wall, {n / 1e6 / t:.2f} Mbp/s, "
              f"phases {json.dumps(prof)}")
    print(f"{tag} host engine: {t_host:.3f} s wall")
    n_sds = sum(len(f) for f in json.loads(host)["families"])
    print(f"{tag} JSON {len(host)} bytes, {n_sds} SDs; peak device memory "
          f"of the cold run {peak} B = {peak / fused_rows:.2f} B per fused "
          f"row ({fused_rows} rows of the checked build)")
    if shards > 1:
        print(f"{tag} pipelined run peak {peak} B vs the largest window "
              f"build alone {largest} B: the host tails hold "
              f"{max(0, peak - largest)} B of device memory")
    print(f"{tag} launches on the main path: {json.dumps(counts)}",
          flush=True)
    for tag2, (_, text, _) in runs.items():
        if text != host:
            raise AssertionError(f"{tag} cuda {tag2} JSON differs from the "
                                 f"host engine's ({len(text)} vs "
                                 f"{len(host)} bytes)")
    if n_sds < min_sds:
        raise AssertionError(f"{n_sds} duplications found on {tag}, "
                             f"expected at least {min_sds}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} main path")
    for row in rows:
        row["launches"] = counts[row["name"]]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows, host


def run_device_chain_whole(fa: str, device, host: str,
                           plain_events: int) -> list:
    """The fused whole genome at k = 20 with ``ASGART_DEVICE_CHAIN=1``
    (:func:`device_chain_run`, from an empty index cache), held to the
    whole path's host JSON, then :func:`kn_checks`. Returns KN's row."""
    import torch

    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.structs import RunSettings

    path, k = "whole", 20
    tag = f"device_chain {path} k={k}"
    s = RunSettings(probe_size=k, reverse=True, complement=True)
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    counts, largest, _ = device_chain_run(
        tag, lambda prof: search_duplications(
            [fa], s, engine="cuda", device=device, profile=prof), host,
        WHOLE, device)
    rows = []
    kn_checks(recorder(rows, path, k), tag, largest, plain_events)
    rows[-1]["launches"] = counts["chain_bursts"]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows


def run_whole_sliced(fa: str, device, host: str) -> list:
    """``whole_sliced``: the whole path (the fused engine, k = 20, -RC)
    with ``ASGART_DEVICE_SLICE_LANES`` set to a quarter of its largest
    chunk's raw total (halved until that chunk takes at least four
    slices; any other chunk whose total reaches the budget is sliced too):
    :func:`sliced_checks` on that chunk; then, each from an empty index
    cache, a run on the host chain and one on the device chain
    (:func:`device_chain_run`), each launching every kernel of the whole
    path and KO (the device chain also KP and KN), with its JSON held to
    the whole path's host JSON ``host``. Returns the rows of KO and KP with
    their launches."""
    import torch

    from asgart_tpu_torch import device_engine as de
    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.kernels.scan_core import fused_bases
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.structs import RunSettings

    path, k = "whole_sliced", 20
    tag = f"{path} k={k}"
    s = RunSettings(probe_size=k, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    INDEX_CACHE.clear()
    idx = de.FusedEngine(strand, s, device, cache=None).ensure_index(chunks)
    (cs, cl, nc), (off, total) = max(
        ((sp, idx.offs[sp[:2]]) for sp in idx.specs),
        key=lambda x: x[1][1])
    lanes = tuple(t[off: off + nc] for t in
                  (idx.lane_lo, idx.lane_hi, idx.lane_mask))
    # a quarter of the total, halved while the windows' spread across the
    # granules leaves fewer than four slices
    budget = total // 4
    while budget and len(de.slice_plan(*lanes, budget)) < 4:
        budget //= 2
    rows = []
    record = recorder(rows, path, k)
    before = os.environ.get("ASGART_DEVICE_SLICE_LANES")
    os.environ["ASGART_DEVICE_SLICE_LANES"] = str(budget)
    try:
        plan = sliced_checks(record, tag, s, (cs, cl), lanes, idx.sa,
                             fused_bases(cs, cl))
        if len(plan) < 4:
            raise AssertionError(f"{tag}: {len(plan)} slices, not 4 or more")
        del idx, lanes
        torch.cuda.empty_cache()
        kmod.reset_launch_counts()
        sliced = de.scan_lanes.sliced
        prof: dict = {}
        t0 = time.time()
        text = json_text(search_duplications(
            [fa], s, engine="cuda", device=device, profile=prof))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kmod.launch_counts()
        sliced = de.scan_lanes.sliced - sliced
        print(f"{tag} cuda (host chain): {wall:.3f} s wall, phases "
              f"{json.dumps(prof)}; {sliced} chunks sliced; launches "
              f"{json.dumps({m: v for m, v in counts.items() if v})}",
              flush=True)
        if text != host:
            raise AssertionError(f"{tag}: the JSON differs from the whole "
                                 f"path's host JSON ({len(text)} vs "
                                 f"{len(host)} bytes)")
        for name in WHOLE + ("granule_totals",):
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"the {tag} main path")
        if not sliced:
            raise AssertionError(f"{tag}: no chunk was sliced")
        INDEX_CACHE.clear()
        torch.cuda.empty_cache()
        dc_counts, _, _ = device_chain_run(
            f"device_chain {tag}", lambda prof: search_duplications(
                [fa], s, engine="cuda", device=device, profile=prof), host,
            WHOLE + ("granule_totals", "gather_flat"), device)
    finally:
        if before is None:
            del os.environ["ASGART_DEVICE_SLICE_LANES"]
        else:
            os.environ["ASGART_DEVICE_SLICE_LANES"] = before
    for row in rows:
        row["launches"] = (dc_counts if row["name"] == "gather_flat"
                           else counts)[row["name"]]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows


def mj_ballast(n1: int, W: int, k: int, keys_held: bool, device):
    """A tensor on the card that leaves ``fused_index.free_bytes`` midway
    between the merge-join engine's projection for a W-row window (with
    the n1 resident code bytes, and the held probe keys of a sharded run)
    and the fused build's, so that the router takes the merge-join engine
    by memory alone. A cached index does not change ``free_bytes`` (it
    counts as reclaimable), so the warm run routes the same way."""
    import torch

    from asgart_tpu_torch.fused_index import (
        INDEX_CACHE, MJ_BYTES_PER_LANE, MJ_KEY_BYTES_PER_LANE,
        MJ_PEAK_BYTES_PER_ROW, PEAK_BYTES_PER_ROW, free_bytes,
        projected_rows)

    lanes = n1 // (k // 2)
    build = MJ_PEAK_BYTES_PER_ROW * W
    if keys_held:
        build += MJ_KEY_BYTES_PER_LANE * lanes
    mj = max(build, 12 * W + MJ_BYTES_PER_LANE * lanes) + n1
    fused = projected_rows(n1, W, k) * PEAK_BYTES_PER_ROW[1] + n1
    if mj >= fused:
        raise AssertionError(f"no free memory routes a {W}-row window to "
                             f"the merge-join engine ({mj} >= {fused} B)")
    INDEX_CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = int(free_bytes(device) - (mj + fused) // 2)
    print(f"ballast {nbytes} B leaves {(mj + fused) // 2} B free: the "
          f"merge-join projection {mj} B, the fused build's {fused} B",
          flush=True)
    return torch.empty(nbytes, dtype=torch.uint8, device=device), nbytes


def run_mj_path(fa: str, n: int, device, path: str, settings,
                shards: int = 1, host: str | None = None,
                min_sds: int = 1, big: bool = False,
                plain_events: int = 0) -> tuple[list, str]:
    """A merge-join path, which the router takes because a ballast tensor
    (:func:`mj_ballast`, held for the path's two runs) leaves too little
    memory for the fused build; or with ``big`` because
    ``pipeline.BIG_WINDOW_SPAN`` is 0 for the path's two runs (the route
    past int32 addressing, where the fused build drops out). The kernel
    checks (the trim window, or window 2 of the shards),
    each window's build and stage-1 peaks, the host engine unless its
    JSON ``host`` is given, then two runs through the user entry point
    (trim: cold, then a cache hit that launches neither KA nor KH; shards:
    two full runs, each packing the probe keys once), with every launch
    counter set to 0 just before and read after each run; with
    ``plain_events`` (not with ``big``), a third run with
    ``ASGART_DEVICE_CHAIN=1`` (:func:`device_chain_run`, behind a ballast
    made for it: the first one's margin need not hold after two runs) and
    :func:`kn_checks`. Returns the path's kernel rows with their main-path
    launch counts, and the host JSON."""
    import torch

    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import plan_windows, search_duplications

    k = settings.probe_size
    tag = f"{path} k={k}"
    windows = plan_windows(n, shards) if shards > 1 else [settings.trim]
    rows, W, lanes = mj_kernel_checks(fa, path, settings, device,
                                      windows[2 if shards > 1 else 0])
    largest = mj_peaks(fa, settings, windows, device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if host is None:
        t0 = time.time()
        host = json_text(search_duplications([fa], settings,
                                             engine="host"))
        print(f"{tag} host engine: {time.time() - t0:.3f} s wall")

    span = pipeline.BIG_WINDOW_SPAN
    if big:
        # at this size the probed text stays within int32 addressing,
        # where the fused build drops out: every window takes the
        # merge-join engine
        pipeline.BIG_WINDOW_SPAN, nb = 0, 0
        INDEX_CACHE.clear()
        torch.cuda.empty_cache()
    else:
        # the first window is the largest; the genome is one record (n +
        # '$')
        ws_we = windows[0]
        ballast, nb = mj_ballast(n + 1, ws_we[1] - ws_we[0] + 1, k,
                                 shards > 1, device)
    try:
        torch.cuda.reset_peak_memory_stats(device)
        kmod.reset_launch_counts()
        runs = {}
        for tag2 in (("cold", "second") if shards > 1 else ("cold", "warm")):
            before = kmod.launch_counts()
            prof: dict = {}
            t0 = time.time()
            res = search_duplications([fa], settings, engine="cuda",
                                      device=device, shards=shards,
                                      profile=prof)
            torch.cuda.synchronize()
            t = time.time() - t0
            after = kmod.launch_counts()
            runs[tag2] = (t, json_text(res), prof,
                          {m: after[m] - before[m] for m in after})
            if tag2 == "cold":
                peak = torch.cuda.max_memory_allocated(device) - nb
        counts = kmod.launch_counts()
    finally:
        pipeline.BIG_WINDOW_SPAN = span
        if not big:
            del ballast
    if plain_events and not big:  # behind a ballast of its own
        ballast, nb = mj_ballast(n + 1, ws_we[1] - ws_we[0] + 1, k,
                                 shards > 1, device)
        try:
            dc_counts, dc_largest, _ = device_chain_run(
                f"device_chain {tag}", lambda prof: search_duplications(
                    [fa], settings, engine="cuda", device=device,
                    shards=shards, profile=prof), host, MJ, device, nb)
        finally:
            del ballast

    for tag2, (t, text, prof, c) in runs.items():
        print(f"{tag} cuda {tag2}: {t:.3f} s wall, {n / 1e6 / t:.2f} Mbp/s, "
              f"phases {json.dumps(prof)}, launches {json.dumps(c)}")
    n_sds = sum(len(f) for f in json.loads(host)["families"])
    print(f"{tag} JSON {len(host)} bytes, {n_sds} SDs; peak device memory "
          f"of the cold run {peak} B{'' if big else ' (ballast excluded)'} "
          f"against the largest window build alone {largest} B ({W} window "
          f"rows, {lanes} probe lanes)")
    print(f"{tag} launches on the main path: {json.dumps(counts)}",
          flush=True)
    for tag2, (_, text, _, _) in runs.items():
        if text != host:
            raise AssertionError(f"{tag} cuda {tag2} JSON differs from the "
                                 f"host engine's ({len(text)} vs "
                                 f"{len(host)} bytes)")
    if n_sds < min_sds:
        raise AssertionError(f"{n_sds} duplications found on {tag}, "
                             f"expected at least {min_sds}")
    for name in MJ:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} main path")
    if shards > 1:
        for tag2, (_, _, _, c) in runs.items():
            # one window-key pack per window, one probe pack per run
            if c["pack_keys"] != len(windows) + 1 \
                    or c["mj_ranges"] != len(windows):
                raise AssertionError(f"{tag} {tag2}: pack_keys "
                                     f"{c['pack_keys']}, mj_ranges "
                                     f"{c['mj_ranges']} launches for "
                                     f"{len(windows)} windows")
            # one key directory a window build
            if c["mj_directory"] != len(windows):
                raise AssertionError(f"{tag} {tag2}: mj_directory "
                                     f"{c['mj_directory']} launches for "
                                     f"{len(windows)} windows")
    elif runs["warm"][3]["pack_keys"] or runs["warm"][3]["mj_ranges"] \
            or runs["warm"][3]["mj_directory"]:
        raise AssertionError(f"{tag} warm run (a cache hit) launched KA, "
                             "KH or KH's directory")
    for row in rows:
        row["launches"] = counts[row["name"]]
    if plain_events and not big:
        kn_checks(recorder(rows, path, k), f"device_chain {tag}",
                  dc_largest, plain_events)
        rows[-1]["launches"] = dc_counts["chain_bursts"]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows, host


def device_chain_run(tag: str, run, ref: str, kernels, device,
                     ballast: int = 0):
    """``run()`` (a ``search_duplications(engine="cuda")`` call) with
    ``ASGART_DEVICE_CHAIN=1`` in the process, every launch counter set to
    0 just before and read just after: its JSON must be ``ref``, every
    kernel of ``kernels`` and KN must have been launched, and the host
    event chain (``native.chain_events``) never called. Prints the wall,
    the chunks chained, their bursts and longest burst, KN's passes and the
    run's peak device memory (less ``ballast`` bytes). Returns (launch
    counts, the largest chunk's (Events, ChainConfig, ChainStats), the
    peak)."""
    import torch

    from asgart_tpu_torch import device_engine, native
    from asgart_tpu_torch import kernels as kmod

    seen = {"stats": [], "largest": None}
    chain = device_engine.chain_events_tensors
    host_chain = native.chain_events
    host_calls = []

    def spy(ev, cfg, *a, **kw):
        out = chain(ev, cfg, *a, **kw)
        seen["stats"].append(out[1])
        if seen["largest"] is None or \
                out[1].matches > seen["largest"][2].matches:
            seen["largest"] = (ev, cfg, out[1])
        return out

    def counted(*a, **kw):
        host_calls.append(1)
        return host_chain(*a, **kw)

    device_engine.chain_events_tensors = spy
    native.chain_events = counted
    os.environ["ASGART_DEVICE_CHAIN"] = "1"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kmod.reset_launch_counts()
        prof: dict = {}
        t0 = time.time()
        res = run(prof)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kmod.launch_counts()
        peak = torch.cuda.max_memory_allocated(device) - ballast
    finally:
        del os.environ["ASGART_DEVICE_CHAIN"]
        device_engine.chain_events_tensors = chain
        native.chain_events = host_chain
    text = json_text(res)
    st = seen["stats"]
    print(f"{tag} device chain: {wall:.3f} s wall, phases {json.dumps(prof)}"
          f"; {len(st)} chunks chained on the card, "
          f"{sum(x.events for x in st)} events, "
          f"{sum(x.matches for x in st)} matches, "
          f"{sum(x.bursts for x in st)} bursts, the longest "
          f"{max((x.longest for x in st), default=0)} events, KN passes "
          f"{[x.passes for x in st]}; peak device memory {peak} B; launches "
          f"{json.dumps({m: v for m, v in counts.items() if v})}",
          flush=True)
    if text != ref:
        raise AssertionError(f"{tag}: the device chain's JSON differs from "
                             f"the reference ({len(text)} vs {len(ref)} "
                             "bytes)")
    if host_calls:
        raise AssertionError(f"{tag}: the host chain ran {len(host_calls)} "
                             "times under ASGART_DEVICE_CHAIN")
    for name in (*kernels, "chain_bursts"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} device-chain run")
    return counts, seen["largest"], peak


def burst_prefix(ev, burst_start, b: int, n: int, t_split: int):
    """The first ``n`` events of burst ``b`` of ``ev`` as an event stream
    of their own, ended by ``t_split`` quiet probes (so every arm left
    dies and emits, as at a burst's end)."""
    import torch

    from asgart_tpu_torch.chain import Events

    lo = int(burst_start[b])
    hi = lo + n
    m_lo, m_hi = int(ev.m_off[lo]), int(ev.m_off[hi])
    return Events(ev.ev_i[lo:hi].contiguous(), ev.ev_z[lo:hi].contiguous(),
                  (ev.m_off[lo:hi + 1] - m_lo).contiguous(),
                  ev.m[m_lo:m_hi].contiguous(),
                  torch.full((1,), t_split, dtype=torch.int32,
                             device=ev.m.device), ev.m_offset)


def kn_checks(record, tag: str, largest, plain_events: int) -> None:
    """KN on the largest chunk's events of a device-chain run: against
    ``native.chain_events`` on the whole chunk (families equal; timed: one
    KN pass at the capacities the chain ended with, the whole device
    chain, the host chain), and against its plain version (tolerance 0,
    each check emitting rows) on (a) the bursts that emit rows, shortest
    first, each of at most PLAIN_LONGEST events, the longest burst too if
    it is that short, topped up with bursts of at most PLAIN_BURST events
    in time order, ``plain_events`` events in all; (b) where the longest
    burst is longer, its first PLAIN_LONGEST events (:func:`burst_prefix`);
    each also with one arm and one output row (both retries), with the
    arms in global scratch, on the block path alone and with most bursts
    handed over to it (a warp budget of 4 arms). Records KN's row: KN's
    time, the plain time and the bound on the same checked events, and the
    chunk's numbers beside them (with the longest burst's time per
    event)."""
    import numpy as np
    import torch

    from asgart_tpu_torch import native
    from asgart_tpu_torch.chain import (burst_threshold, bursts_from_events,
                                        chain_rows, families_from_rows)
    from asgart_tpu_torch.kernels import chain as kc

    def work(e, n_ev, n_m, n_rows):  # events and matches read, rows written
        return n_ev * 16 + n_m * e.m.element_size() + n_rows * 48

    ev, cfg, st = largest
    rows, st = chain_rows(ev, cfg)
    t = burst_threshold(cfg)
    bs, order = bursts_from_events(ev, t)
    chain_ms = cuda_ms(lambda: chain_rows(ev, cfg), reps=1)
    chunk_ms = cuda_ms(lambda: kc.chain_bursts(
        ev.ev_i, ev.ev_z, ev.m_off, ev.m, ev.m_offset, bs, order,
        ev.z_trail, t, cfg.probe_size, cfg.step_size, cfg.max_gap_size,
        cfg.min_duplication_length, st.arms, max(st.rows, 1)), reps=1)
    ev_i, ev_z, m_off, m = (x.cpu().numpy()
                            for x in (ev.ev_i, ev.ev_z, ev.m_off, ev.m))
    m = m.astype(np.int64) + ev.m_offset
    t0 = time.time()
    want = native.chain_events(
        ev_i, ev_z, m_off, m, z_trail=int(ev.z_trail),
        probe_size=cfg.probe_size, step_size=cfg.step_size,
        max_gap_size=cfg.max_gap_size,
        min_duplication_length=cfg.min_duplication_length,
        max_cardinality=cfg.max_cardinality)
    host_ms = (time.time() - t0) * 1e3
    if families_from_rows(rows.cpu().numpy()) != want:
        raise AssertionError(f"{tag}: KN's families differ from "
                             "native.chain_events on the largest chunk")
    # the plain version (one lockstep step per event position, a few ms on
    # the card) on (a) the bursts that emit rows and (b) the longest
    # burst's first events; (a) sorted by length, so that the plain
    # version's lockstep groups of bursts are even
    lens = (bs[1:] - bs[:-1]).cpu().numpy()
    b_m = ev.m_off[bs]
    b_m = (b_m[1:] - b_m[:-1]).cpu().numpy()  # each burst's matches
    longest = int(order[0])
    pick, total = [], 0
    emitting = np.unique((rows[:, 0] >> 32).cpu().numpy()).tolist()
    for b in sorted(emitting, key=lambda b: (lens[b], b)):
        if lens[b] > PLAIN_LONGEST or total + lens[b] > plain_events:
            break
        pick.append(b)
        total += int(lens[b])
    if lens[longest] <= PLAIN_LONGEST and longest not in pick:
        pick.append(longest)
        total += int(lens[longest])
    chosen = set(pick)
    for b, n_ev in enumerate(lens.tolist()):
        if total + PLAIN_BURST > plain_events:
            break
        if n_ev <= PLAIN_BURST and b not in chosen:
            pick.append(b)
            total += n_ev
    pick.sort(key=lambda b: (lens[b], b))
    checks = []
    if pick:
        checks.append((ev, torch.tensor(pick, dtype=torch.int32,
                                        device=ev.m.device)))
    if lens[longest] > PLAIN_LONGEST:
        checks.append((burst_prefix(ev, bs, longest, PLAIN_LONGEST, t),
                       None))
    err, ms, plain_ms, nbytes, tests = 0, 0.0, 0.0, 0, 0
    n_bursts, n_events, n_rows = 0, 0, 0
    for e, sub in checks:
        ids = None if sub is None else sub.long().cpu().numpy()
        n_sub = e.ev_i.numel() if sub is None else int(lens[ids].sum())
        n_m = int(e.m_off[-1]) if sub is None else int(b_m[ids].sum())
        torch.cuda.synchronize()
        t0 = time.time()
        want_rows, p_st = chain_rows(e, cfg, kc.chain_bursts_plain, sub)
        torch.cuda.synchronize()
        p_ms = (time.time() - t0) * 1e3
        got, k_st = chain_rows(e, cfg, bursts=sub)
        k_ms = cuda_ms(lambda: chain_rows(e, cfg, bursts=sub), reps=1)
        small, s_st = chain_rows(e, cfg._replace(max_arms=1, out_cap=1),
                                 bursts=sub)
        limit, warp = kc.SMEM_LIMIT, kc.WARP_ARMS
        kc.SMEM_LIMIT = 0  # the arms in global scratch
        try:
            scratch, _ = chain_rows(e, cfg._replace(max_arms=4), bursts=sub)
            kc.SMEM_LIMIT = limit
            # the block path alone, and most bursts handed over to it
            kc.WARP_ARMS = 0
            block, b_st = chain_rows(e, cfg, bursts=sub)
            kc.WARP_ARMS = 4
            handed, h_st = chain_rows(e, cfg, bursts=sub)
        finally:
            kc.SMEM_LIMIT, kc.WARP_ARMS = limit, warp
        for x in (got, small, scratch, block, handed):
            err = max(err, max_abs_err((x,), (want_rows,)))
        for st_x in (k_st, b_st, h_st):
            if st_x.tests != p_st.tests:
                raise AssertionError(f"{tag}: KN's test count {st_x.tests} "
                                     f"!= the plain version's {p_st.tests}")
        what = (f"{k_st.bursts} bursts" if sub is not None else
                f"the longest burst's first {n_sub} events")
        print(f"{tag} KN against its plain version on {what} ({n_sub} "
              f"events, {n_m} matches, {p_st.rows} rows): "
              f"max_abs_err {err} (warp path, block path alone, handed "
              f"over at 4 arms, arms in global scratch); one arm and one "
              f"row: {s_st.passes} passes; KN {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms", flush=True)
        ms += k_ms
        plain_ms += p_ms
        nbytes += work(e, n_sub, n_m, k_st.rows)
        tests += k_st.tests
        n_bursts += k_st.bursts
        n_events += n_sub
        n_rows += k_st.rows
    if n_rows == 0:
        raise AssertionError(f"{tag}: the plain version emitted no row on "
                             "the checked events: the check compares no "
                             "family")
    n_cut = sum(sub is None for _, sub in checks)
    chunk_bound, _ = bound(work(ev, st.events, st.matches, st.rows),
                           st.tests)
    print(f"{tag} KN on the largest chunk ({st.events} events, {st.matches} "
          f"matches, {st.bursts} bursts, the longest {st.longest} events, "
          f"{st.tests} native tests, {st.rows} rows, {st.arms} arms): one "
          f"pass {chunk_ms:.3f} ms (bound {chunk_bound:.6f} ms), "
          f"{chunk_ms * 1e3 / st.longest:.4f} us an event of the longest "
          f"burst (bound {chunk_bound * 1e3 / st.longest:.6f}), the device "
          f"chain {chain_ms:.3f} ms, the host chain on the same events "
          f"{host_ms:.3f} ms", flush=True)
    record("chain_bursts", "chain.cu", "asgart_tpu/chain_jax.py:337", err,
           ms, plain_ms, f"{n_bursts - n_cut} bursts + {n_cut} cut burst "
           f"({n_events} events, {n_rows} rows) of a chunk of "
           f"{st.events} events, {st.matches} matches", nbytes, tests)
    # the chunk's numbers beside the checked events' (ms, plain_ms and the
    # bound above): one KN pass, the whole device chain, the host chain
    record.rows[-1].update(
        checked_events=n_events, checked_bursts=n_bursts,
        checked_rows=n_rows, checked_tests=tests, chunk_ms=chunk_ms,
        chunk_bound_ms=chunk_bound, chain_ms=chain_ms,
        longest_us_per_event=chunk_ms * 1e3 / st.longest,
        host_chain_ms=host_ms, events=st.events, matches=st.matches,
        bursts=st.bursts, longest=st.longest, passes=st.passes,
        arms=st.arms, tests=st.tests, rows=st.rows)


def repeat_genome(n: int):
    """A repeat-dense genome of n bases made from the seed: random
    background; 40% of its bases in copies of 300 Alu-like elements of 300
    bp (each copy 1.5% divergent, half of them reverse-complemented, laid
    on a 300 bp grid); and one 1/20-genome segment copied twice, exactly,
    once direct and once reverse-complemented. More than a quarter of its
    direct 20-mers lie in tied groups."""
    import numpy as np

    rng = np.random.default_rng([SEED, 7])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    g = acgt[rng.integers(0, 4, n, dtype=np.uint8)]
    elements = acgt[rng.integers(0, 4, (300, 300), dtype=np.uint8)]
    n_copies = int(0.4 * n / 300)
    at = rng.choice(n // 300, n_copies, replace=False) * 300
    copies = elements[rng.integers(0, 300, n_copies)]
    mut = rng.random(copies.shape) < 0.015
    copies[mut] = acgt[rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)]
    rc = rng.random(n_copies) < 0.5
    copies[rc] = comp[copies[rc]][:, ::-1]
    for i in range(0, n_copies, 1 << 16):  # bounded index arrays
        g[at[i:i + (1 << 16), None] + np.arange(300)] = copies[i:i + (1 << 16)]
    seg = n // 20
    src = int(rng.integers(0, n - seg))
    for rev in (False, True):
        dst = int(rng.integers(0, n - seg))
        copy = g[src:src + seg].copy()
        g[dst:dst + seg] = comp[copy][::-1] if rev else copy
    return g


def table_ties(record, tag: str, sa, rank, tied, n: int, n1: int, k: int,
               device):
    """The table build's tie resolution at the default ``tied_cap``: when
    the first tied count passes it, KK / KL on the first full round
    against their plain versions (each side on its own copies of the rank)
    and the full rounds with them; then KE / KF on the first subset round
    (:func:`tie_checks`). Returns (resolved sa, first tied count, full
    rounds run)."""
    import torch

    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.kernels import full_round_keys, full_round_refine
    from asgart_tpu_torch.kernels.ties import (full_round_keys_plain,
                                               full_round_refine_plain)

    cap = max(1024, n // 8)
    first = int(tied.sum())
    print(f"{tag} first tied count {first} of {n1} direct rows "
          f"({100 * first / n1:.2f}%), tied_cap {cap} (n // 8): "
          f"{'full rounds first' if first > cap else 'subset rounds only'}",
          flush=True)
    rounds, h = 0, k
    if first > cap:
        kk = lambda: full_round_keys(rank, h, n1)  # noqa: E731
        pk = lambda: full_round_keys_plain(rank, h, n1)  # noqa: E731
        key = kk()
        err = max_abs_err((key,), (pk(),))
        record("full_round_keys", "ties.cu",
               "asgart_tpu/device_index.py:769", err, cuda_ms(kk, FINE_REPS),
               cuda_ms(pk), f"n={n} rows, h={h}, keys in position order",
               12 * n, 8 * n, alone=(kernel_ms(kk, FINE_REPS), None))
        skey, order = torch.sort(key, stable=True)
        del key
        rank_k, rank_p = rank.clone(), rank.clone()
        kl = lambda: full_round_refine(skey, order, rank_k, n1)  # noqa: E731
        pl = lambda: full_round_refine_plain(skey, order,  # noqa: E731
                                             rank_p, n1)
        got, want = kl(), pl()
        err = max_abs_err((*got, rank_k), (*want, rank_p))
        record("full_round_refine", "ties.cu",
               "asgart_tpu/device_index.py:769", err,
               cuda_ms(kl, FINE_REPS), cuda_ms(pl), f"n={n} rows", 25 * n,
               20 * n, alone=(kernel_ms(kl, FINE_REPS), None))
        del skey, order, rank_k, rank_p, got, want
        torch.cuda.empty_cache()
        before = full_round_keys.launches
        torch.cuda.synchronize()
        t0 = time.time()
        sa, tied, h = ties_mod.full_rounds(sa, rank, tied, k, cap, n1)
        torch.cuda.synchronize()
        rounds = full_round_keys.launches - before
        print(f"{tag} {rounds} full rounds (KK, sort, KL) in "
              f"{time.time() - t0:.4f} s (host clock + sync): "
              f"{int(tied.sum())} rows still tied at h={h}", flush=True)
    if tied.any():
        sa = tie_checks(record, tag, sa, rank[:n1], tied, n, k, device, h)
    return sa, first, rounds


def table_kernel_checks(fa: str, path: str, settings, device
                        ) -> tuple[list, int, int, int]:
    """Each kernel of the table engine against its plain version at the
    shapes of the path's genome: KI, KA's doubled mode, the sort, KB with
    the N flag (and run ends without an appended half), KJ (and three
    ``index_put_`` calls), the tie resolution (:func:`table_ties`), KM
    (and torch gathers with the masks) and KD on the largest chunk; the
    step-by-step index against ``DeviceIndex.build``'s, and the build's
    peak per text row against ``TABLE_PEAK_BYTES_PER_ROW``; where a
    chunk's raw total reaches the slice budget, :func:`sliced_checks` on
    the largest such chunk. Returns (kernel rows, text rows n, first tied
    count, full rounds, each chunk's slice count, 0 where unsliced)."""
    import torch

    from asgart_tpu_torch.device_engine import chunk_specs, slice_plan
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import (TABLE_PEAK_BYTES_PER_ROW,
                                              sort_keys)
    from asgart_tpu_torch.host_helpers import _slice_budget
    from asgart_tpu_torch.kernels.scan_core import fused_bases
    from asgart_tpu_torch.kernels import (group_bounds, invert_tables,
                                          pack_keys, table_ranges)
    from asgart_tpu_torch.kernels.group_bounds import (group_bounds_plain,
                                                       n_flag_shift)
    from asgart_tpu_torch.kernels.pack_keys import pack_keys_plain
    from asgart_tpu_torch.kernels.tables import (decimated_index,
                                                 decimated_size,
                                                 invert_tables_plain,
                                                 table_ranges_plain,
                                                 table_x0s)
    from asgart_tpu_torch.table_index import DeviceIndex

    s = settings
    k = s.probe_size
    rc = (s.reverse, s.complement)
    doubled = s.reverse or s.complement
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    n = 2 * n1 - 1 if doubled else n1
    rows = []
    tag = f"{path} k={k}"
    record = recorder(rows, path, k)

    codes = ki_check(record, tag, strand.data, device)
    ka = lambda: pack_keys(codes, (), k, *rc, n, 0,  # noqa: E731
                           doubled=doubled)
    kp = lambda: pack_keys_plain(codes, [0], [], [], k, *rc, n, 0,  # noqa: E731
                                 0, doubled)
    keys, _ = ka()
    err = max_abs_err(keys, kp()[0])
    words = len(keys)
    kwb = 8 if words == 1 else 12  # key bytes per row
    record("pack_keys", "pack_keys.cu",
           "asgart_tpu/device_index.py:244 + :269" if words == 1 else
           "asgart_tpu/device_index.py:244 + :283", err,
           cuda_ms(ka, FINE_REPS), cuda_ms(kp),
           f"n={n} text rows, {words} key words", n1 + n * kwb,
           n * (4 * k + 8), alone=(kernel_ms(ka, FINE_REPS), None))
    del codes
    torch.cuda.empty_cache()

    ms = cuda_ms(lambda: sort_keys([w.clone() for w in keys]))
    sort_bound, sort_by = bound(n * (2 * kwb + 4), 0)
    skeys, sa = sort_keys(keys)
    print(f"{tag} stable sort of {n} text rows by {words} key word(s) "
          f"(fused_index.sort_keys, torch.sort): {ms:.3f} ms (CUDA events, "
          f"incl. a copy of the keys), bound {sort_bound:.3f} ms "
          f"({sort_by})", flush=True)

    shift = n_flag_shift(k, words)
    kb = lambda: group_bounds(skeys, sa, n1, flag_n_k=k,  # noqa: E731
                              run_end=not doubled)
    pb = lambda: group_bounds_plain(skeys, sa, n1, shift,  # noqa: E731
                                    not doubled)
    run_lo, run_hi, tied = kb()
    err = max_abs_err((run_lo, run_hi, tied), pb())
    record("group_bounds", "group_bounds.cu",
           "asgart_tpu/device_index.py:352", err, cuda_ms(kb), cuda_ms(pb),
           f"n={n}, {words} key words, N flag"
           + ("" if doubled else ", run ends"), n * (kwb + 4 + 9), n * 24)
    del skeys
    torch.cuda.empty_cache()

    step = k // 2
    kj = lambda: invert_tables(sa, run_lo, run_hi, step)  # noqa: E731
    pj = lambda: invert_tables_plain(sa, run_lo, run_hi, step)  # noqa: E731
    tables = kj()
    err = max_abs_err(tables, pj())
    C, _ = decimated_size(n, step)
    sa64 = sa.long()
    dec64 = decimated_index(sa64, step, C)  # the planes' decimated index
    lib = [torch.zeros(step * C, dtype=torch.int32, device=device)
           for _ in range(2)] + [torch.empty(n, dtype=torch.int32,
                                             device=device)]

    def lj():  # three index_put_ calls (and the sign mask)
        lib[0].index_put_((dec64,), run_lo)
        lib[1].index_put_((dec64,), run_hi)
        lib[2].index_put_((sa64,), run_lo & 0x7FFFFFFF)

    lib_ms = cuda_ms(lj, FINE_REPS)
    if any(not torch.equal(a, b) for a, b in zip(lib, tables)):
        raise AssertionError(f"index_put_ differs from KJ on {tag}")
    record("invert_tables", "invert.cu", "asgart_tpu/device_index.py:467",
           err, cuda_ms(kj, FINE_REPS), cuda_ms(pj),
           f"n={n}, the table form of KC's scatter, pos_lo / pos_hi "
           f"decimated by step {step}", 24 * n, 3 * n, library_ms=lib_ms,
           alone=(kernel_ms(kj, FINE_REPS), kernel_ms(lj, FINE_REPS)))
    del run_lo, run_hi, sa64, dec64, lib
    pos_lo, pos_hi, rank = tables
    del tables
    torch.cuda.empty_cache()

    sa, first, rounds = table_ties(record, tag, sa, rank, tied, n, n1, k,
                                   device)
    del rank, tied
    torch.cuda.empty_cache()

    km = lambda: table_ranges(pos_lo, pos_hi, specs, n1, k, *rc)  # noqa: E731
    tabs = table_x0s(specs, n1, k, *rc)
    pm = lambda: table_ranges_plain(pos_lo, pos_hi, *tabs, k,  # noqa: E731
                                    n)
    lane_lo, lane_hi, lane_mask, totals, lane_off = km()
    err = max_abs_err((lane_lo, lane_hi, lane_mask, totals), pm())
    total = lane_off[-1]
    x = torch.cat([torch.arange(nc, device=device) * step + x0
                   for x0, (_, _, nc) in zip(tabs[1], specs)])
    live = torch.cat([torch.arange(nc, device=device) * step < cl - k - step
                      for (_, cl, nc) in specs]) & (x < n)
    x = torch.where(live, decimated_index(x, step, C), 0)

    def lm():  # gathers at the probe positions, then the masks
        lo = pos_lo.index_select(0, x)
        mask = live & (lo >= 0)
        return (torch.where(mask, lo & 0x7FFFFFFF, 0),
                torch.where(mask, pos_hi.index_select(0, x), 0), mask)

    lib_ms = cuda_ms(lm, FINE_REPS)
    if any(not torch.equal(a, b) for a, b in zip(lm(), (lane_lo, lane_hi,
                                                        lane_mask))):
        raise AssertionError(f"torch gathers differ from KM on {tag}")
    record("table_ranges", "tables.cu", "asgart_tpu/device_engine.py:202",
           err, cuda_ms(km, FINE_REPS), cuda_ms(pm), f"{total} lanes of "
           f"{len(specs)} chunks, step {step}, decimated planes",
           17 * total, 12 * total, library_ms=lib_ms,
           alone=(kernel_ms(km, FINE_REPS), kernel_ms(lm, FINE_REPS)))
    del x, live
    kd_check(record, s, specs, lane_off, lane_lo, lane_hi, lane_mask, sa)
    # the chunks whose raw totals reach the slice budget: each one's slice
    # count, and the sliced checks on the largest of them
    tot = totals.tolist()
    lanes = [tuple(t[lane_off[c]: lane_off[c] + nc] for t in
                   (lane_lo, lane_hi, lane_mask))
             for c, (_, _, nc) in enumerate(specs)]
    sliced = [c for c in range(len(specs)) if tot[c] >= _slice_budget()]
    n_slices = {c: len(slice_plan(*lanes[c], _slice_budget()))
                for c in sliced}
    if sliced:
        c = max(sliced, key=lambda i: tot[i])
        cs, cl, _ = specs[c]
        sliced_checks(record, tag, s, (cs, cl), lanes[c], sa,
                      fused_bases(cs, cl))
    del lane_lo, lane_hi, lane_mask, lanes

    # the same index through DeviceIndex.build, alone: its peak per row
    held = (sa, pos_lo, pos_hi)
    del sa, pos_lo, pos_hi
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    idx = DeviceIndex.build(strand.data, k, *rc, device)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) - base
    if any(not torch.equal(a, b) for a, b in
           zip(held, (idx.sa, idx.pos_lo, idx.pos_hi))):
        raise AssertionError(f"DeviceIndex.build differs from the "
                             f"step-by-step build on {tag}")
    per_row = peak / n
    limit = TABLE_PEAK_BYTES_PER_ROW
    print(f"{tag} DeviceIndex.build alone: {t_build:.3f} s (host clock + "
          f"sync), peak {peak} B above the {base} B resident = "
          f"{per_row:.2f} B per text row ({n} rows; "
          f"TABLE_PEAK_BYTES_PER_ROW = {limit})", flush=True)
    if per_row > limit:
        raise AssertionError(f"{tag}: the table build peaks above "
                             "TABLE_PEAK_BYTES_PER_ROW")
    del held, idx
    torch.cuda.empty_cache()
    return rows, n, first, rounds, [n_slices.get(c, 0)
                                    for c in range(len(specs))]


def run_table_path(fa: str, n_bp: int, device, path: str, settings,
                   work: str, kernels=TABLE, min_sds: int = 1,
                   min_tied: int = 0, journal_free: bool = True,
                   last_chunk: bool = True, plain_events: int = 0) -> list:
    """A ``--checkpoint`` path on the table engine: the kernel checks
    (:func:`table_kernel_checks`; the first tied count must pass
    ``min_tied``), the host engine with a journal, then through the user
    entry point with a journal of its own: (a) the cold run, with every
    launch counter set to 0 just before and read just after, which must
    launch ``kernels``; (b) a rerun, which restores every chunk and
    launches nothing; (c) a rerun with the journal's last record removed,
    which scans that chunk alone from the cached index (one KM and one KD
    launch); (d) with ``journal_free``, a run without a journal (the fused
    build). Every JSON must be the host engine's. Without ``last_chunk``
    (c) is left out. With ``plain_events``, then a cold journaled run with
    ``ASGART_DEVICE_CHAIN=1`` (:func:`device_chain_run`, its peak against
    the route's projection) and :func:`kn_checks`. Returns the kernel rows
    with the launches of (a) (KN's: of the device-chain run)."""
    import torch

    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications

    k = settings.probe_size
    tag = f"{path} k={k}"
    rows, n, first, rounds, slices = table_kernel_checks(
        fa, path, settings, device)
    if any(slices):  # KO plans the sliced chunks
        kernels += ("granule_totals",)
    if first <= min_tied:
        raise AssertionError(f"{tag}: first tied count {first} is not "
                             f"above {min_tied}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    journal = os.path.join(work, f"{path}_k{k}.jsonl")
    host_journal = journal + ".host"
    for f in (journal, host_journal):
        if os.path.exists(f):
            os.remove(f)
    t0 = time.time()
    host = json_text(search_duplications([fa], settings, engine="host",
                                         checkpoint=host_journal))
    print(f"{tag} host engine with a journal: {time.time() - t0:.3f} s "
          "wall", flush=True)

    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    runs = {}
    for run in ("cold", "resumed", "last_chunk", "no_journal"):
        if (run == "last_chunk" and not last_chunk) or \
                (run == "no_journal" and not journal_free):
            continue
        if run == "last_chunk":
            with open(journal) as fh:
                lines = fh.read().splitlines()
            with open(journal, "w") as fh:
                fh.write("\n".join(lines[:-1]) + "\n")
        if run == "cold":
            torch.cuda.reset_peak_memory_stats(device)
        kmod.reset_launch_counts()
        prof: dict = {}
        t0 = time.time()
        res = search_duplications(
            [fa], settings, engine="cuda", device=device, profile=prof,
            checkpoint=None if run == "no_journal" else journal)
        torch.cuda.synchronize()
        runs[run] = (time.time() - t0, json_text(res), prof,
                     kmod.launch_counts())
        if run == "cold":
            peak = torch.cuda.max_memory_allocated(device)
    for run, (t, text, prof, c) in runs.items():
        print(f"{tag} cuda {run}: {t:.3f} s wall, {n_bp / 1e6 / t:.2f} "
              f"Mbp/s, phases {json.dumps(prof)}, launches "
              f"{json.dumps({m: v for m, v in c.items() if v})}")
    n_sds = sum(len(f) for f in json.loads(host)["families"])
    counts = runs["cold"][3]
    with open(journal) as fh:
        n_journaled = len(fh.read().splitlines()) - 1
    print(f"{tag} JSON {len(host)} bytes, {n_sds} SDs; {n_journaled} "
          f"chunks journaled; peak device memory of the cold run {peak} B "
          f"= {peak / n:.2f} B per text row ({n} rows); launches on the "
          f"main path (the cold run): {json.dumps(counts)}", flush=True)
    for run, (_, text, _, _) in runs.items():
        if text != host:
            raise AssertionError(f"{tag} cuda {run} JSON differs from the "
                                 f"host engine's ({len(text)} vs "
                                 f"{len(host)} bytes)")
    if n_sds < min_sds:
        raise AssertionError(f"{n_sds} duplications found on {tag}, "
                             f"expected at least {min_sds}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} main path")
    if any(runs["resumed"][3].values()):
        raise AssertionError(f"{tag}: the resumed run launched "
                             f"{runs['resumed'][3]}")
    # KM and KD once, or KM, KO and KD once a slice (a sliced last chunk)
    want = {"table_ranges": 1, "scan_core": 1} if not slices[-1] else \
        {"table_ranges": 1, "granule_totals": 1, "scan_core": slices[-1]}
    last = {m: v for m, v in runs["last_chunk"][3].items() if v} \
        if last_chunk else want
    if last != want:
        raise AssertionError(f"{tag}: the last chunk's rerun launched "
                             f"{last}, not {want}")
    if journal_free and runs["no_journal"][3]["table_ranges"]:
        raise AssertionError(f"{tag}: the run without a journal took the "
                             "table engine, not the fused build")
    for row in rows:
        row["launches"] = counts[row["name"]]
    if plain_events:
        from asgart_tpu_torch.fused_index import TABLE_PEAK_BYTES_PER_ROW

        INDEX_CACHE.clear()
        torch.cuda.empty_cache()
        dj = journal + ".device"
        if os.path.exists(dj):
            os.remove(dj)
        # a sliced chunk's slices merged on the card by KP
        dc_kernels = kernels + (("gather_flat",) if "granule_totals" in
                                kernels else ())
        dc_counts, dc_largest, dc_peak = device_chain_run(
            f"device_chain {tag}", lambda prof: search_duplications(
                [fa], settings, engine="cuda", device=device, profile=prof,
                checkpoint=dj), host, dc_kernels, device)
        for row in rows:
            if row["name"] == "gather_flat":
                row["launches"] = dc_counts["gather_flat"]
        print(f"device_chain {tag}: peak {dc_peak} B = {dc_peak / n:.2f} B "
              f"per text row against the host chain's {peak} B and the "
              f"route's projection {TABLE_PEAK_BYTES_PER_ROW} B per row",
              flush=True)
        if dc_peak > TABLE_PEAK_BYTES_PER_ROW * n:
            raise AssertionError(f"device_chain {tag}: peak {dc_peak} B "
                                 "passes the table route's projection")
        kn_checks(recorder(rows, path, k), f"device_chain {tag}",
                  dc_largest, plain_events)
        rows[-1]["launches"] = dc_counts["chain_bursts"]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows


def big_genome(fa: str, mbp: float) -> dict:
    """Write the big-window genome: records of ``RECORD_BP`` bases (the
    last one shorter), each made from the seed and its index with numpy's
    uint8 integers (no int64 index of the genome is ever held), an
    ``N_RUN_BP`` N run in the middle of the middle and of the last record,
    and one -RC
    pair: ``PLANT_BP`` bases a twentieth of a record into the third
    record (5 Mbp), copied reverse-complemented a fifth of a record before
    the genome's end (20 Mbp; past 2^31 from 2168 Mbp). Returns n and the
    pair's (src, dst)."""
    import numpy as np

    n = int(mbp * 1e6)
    sizes = [RECORD_BP] * (n // RECORD_BP) + ([n % RECORD_BP]
                                              if n % RECORD_BP else [])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    src, dst = 2 * RECORD_BP + RECORD_BP // 20, n - RECORD_BP // 5
    seg = None
    with open(fa, "wb") as fh:
        pos = 0
        for r, size in enumerate(sizes):
            rng = np.random.default_rng([SEED, r])
            seq = acgt[rng.integers(0, 4, size, dtype=np.uint8)]
            if r in (len(sizes) // 2, len(sizes) - 1):
                seq[size // 2: size // 2 + N_RUN_BP] = ord("N")
            if pos <= src < pos + size:
                seg = seq[src - pos: src - pos + PLANT_BP].copy()
            if pos <= dst < pos + size:
                seq[dst - pos: dst - pos + PLANT_BP] = comp[seg][::-1]
            fh.write(b">chr%d\n" % (r + 1))
            fh.write(seq.tobytes())
            fh.write(b"\n")
            pos += size
    return {"n": n, "src": src, "dst": dst, "records": len(sizes)}


def big_whole_checks(tag: str, strand, chunks, settings, window, src: int,
                     device) -> list:
    """Each kernel of the big_whole path against its plain version at
    full scale, on the last window ``window`` (the main path's calls,
    with slices of ``SLICE_ROWS`` rows where a whole-array plain version
    would not fit beside the index): KI over the whole strand; KA's probe
    keys of every chunk, the trailing chunks' (past 2^31) against the
    plain version; KA's window keys, the window's last rows (past 2^31)
    against it; the sort; KB on a slice; KC and KE/KF whole; KH on a slice
    of the sorted keys with the trailing chunks' probes; KD with the
    rebased constants on the last chunk and, unrecorded, on the chunk of
    the planted pair's first copy ``src`` (its constants clamp; its
    probes find the copy in the last window). Returns the kernel
    rows."""
    import torch

    from asgart_tpu_torch.device_engine import chunk_specs, rebased_bases
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          mj_directory, mj_ranges, pack_keys)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)

    s = settings
    k = s.probe_size
    rc = (s.reverse, s.complement)
    path = "big_whole"
    rows = []
    record = recorder(rows, path, k)
    n1 = len(strand.data)
    specs = chunk_specs(chunks, s)
    lane_off, x0s, cls = chunk_tables(specs, n1, k, *rc)
    total = lane_off[-1]
    ws, we = window
    W = we - ws + 1
    codes = ki_check(record, tag, strand.data, device)

    # KA probe-only: every chunk (the main path's call); the trailing
    # chunks, whose probes read codes past 2^31, against the plain version
    c0 = len(specs) - 1
    while c0 > 0 and total - lane_off[c0] < SLICE_ROWS:
        c0 -= 1
    sub = specs[c0:]
    (pkey,), pmask = pack_keys(codes, specs, k, *rc, 0, total)
    sub_off = [o - lane_off[c0] for o in lane_off[c0:]]
    nsub = sub_off[-1]
    kap = lambda: pack_keys(codes, sub, k, *rc, 0, nsub)  # noqa: E731
    pap = lambda: pack_keys_plain(codes, sub_off, x0s[c0:],  # noqa: E731
                                  cls[c0:], k, *rc, 0, nsub)
    (want_key,), want_mask = pap()
    err_p = max_abs_err((pkey[lane_off[c0]:], pmask[lane_off[c0]:]),
                        (want_key, want_mask))
    del want_key, want_mask
    # KA window keys: the whole last window, its last rows against the
    # plain version of the same rows
    R = min(SLICE_ROWS, W)
    (key,), _ = pack_keys(codes, (), k, *rc, W, 0, ws)
    kaw = lambda: pack_keys(codes, (), k, *rc, R, 0, we + 1 - R)  # noqa: E731
    paw = lambda: pack_keys_plain(codes, [0], [], [], k, *rc,  # noqa: E731
                                  R, 0, we + 1 - R)
    err_w = max_abs_err((key[W - R:],), paw()[0])
    times = [cuda_ms(kaw, FINE_REPS), cuda_ms(paw), cuda_ms(kap, FINE_REPS),
             cuda_ms(pap)]
    alone = kernel_ms(kaw, FINE_REPS) + kernel_ms(kap, FINE_REPS)
    # probe-only mode's own bound on the timed lanes: their chunks' codes,
    # 9 B per lane out
    p_bound, p_by = bound(sum(cl for _, cl, _ in sub) + 9 * nsub,
                          nsub * (4 * k + 8))
    print(f"{tag} KA window keys (W={W}, ws={ws}; rows from {we + 1 - R} "
          f"checked): max_abs_err={err_w} kernel {times[0]:.3f} ms, plain "
          f"{times[1]:.3f} ms on {R} rows; probe-only ({total} lanes, "
          f"{nsub} from chunk start {sub[0][0]} checked): "
          f"max_abs_err={err_p} kernel {times[2]:.3f} ms, plain "
          f"{times[3]:.3f} ms, bound {p_bound:.4f} ms ({p_by}) on {nsub} "
          "lanes", flush=True)
    record("pack_keys", "pack_keys.cu",
           "asgart_tpu/device_engine.py:904 + asgart_tpu/device_index.py:269",
           max(err_w, err_p), times[0] + times[2], times[1] + times[3],
           f"{R} window rows from {we + 1 - R} + {nsub} probe lanes from "
           f"{sub[0][0]} (of W={W}, {total} lanes)",
           R + 8 * R + sum(cl for _, cl, _ in sub) + 9 * nsub,
           (R + nsub) * (4 * k + 8), alone=(alone, None))

    (skey,), sa = sort_keys([key])
    del key
    lo_, hi_ = W - R, W
    kb = lambda: group_bounds([skey[lo_:hi_]], sa[lo_:hi_], W)  # noqa: E731
    pb = lambda: group_bounds_plain([skey[lo_:hi_]],  # noqa: E731
                                    sa[lo_:hi_], W)
    err = max_abs_err(kb(), pb())
    record("group_bounds", "group_bounds.cu",
           "asgart_tpu/device_index.py:433", err, cuda_ms(kb), cuda_ms(pb),
           f"{R} sorted rows of W={W}, every row direct", R * (8 + 4 + 9),
           R * 20)
    run_lo, run_hi, tied = group_bounds([skey], sa, W)
    none = torch.zeros(0, dtype=torch.bool, device=device)
    kc = lambda: invert_fused(sa, run_lo, run_hi, none, W, [0])  # noqa: E731
    pc = lambda: invert_fused_plain(sa, run_lo, run_hi, none, W,  # noqa: E731
                                    [0])
    got = kc()
    rank = got[0]
    err = max_abs_err(got, pc())
    del got
    sa64 = sa.long()
    lib = torch.empty(W, dtype=torch.int32, device=device)
    lc = lambda: lib.index_put_((sa64,), run_lo)  # noqa: E731
    record("invert_fused", "invert.cu", "asgart_tpu/device_index.py:631",
           err, cuda_ms(kc), cuda_ms(pc), f"W={W}, no lanes", 12 * W, W,
           library_ms=cuda_ms(lc), alone=(kernel_ms(kc), kernel_ms(lc)))
    if not torch.equal(lib, rank):
        raise AssertionError(f"index_put_ differs from KC on {tag}")
    del run_lo, run_hi, sa64, lib
    torch.cuda.empty_cache()
    sa = tie_checks(record, tag, sa, rank, tied, W, k, device)
    del rank, tied
    torch.cuda.empty_cache()

    # the main path's join: the whole window from its directory
    lane_lo, lane_hi, _ = mj_ranges(skey, pkey, pmask, lane_off,
                                    mj_directory(skey, k).check())
    a = (W - R) // 2  # a slice of the sorted keys, the trailing probes
    kh_checks(record, tag, skey[a:a + R], k, pkey[lane_off[c0]:],
              pmask[lane_off[c0]:], sub_off,
              "asgart_tpu/device_engine.py:788",
              f"{R} sorted rows of W={W} (from slot {a}), lanes from chunk "
              f"start {sub[0][0]}")
    del skey, pkey
    torch.cuda.empty_cache()

    def bases(cs, cl):
        return rebased_bases(cs, cl, ws, W)

    kd_check(record, s, specs, lane_off, lane_lo, lane_hi, pmask, sa, bases,
             chunk=len(specs) - 1)
    kd_check(recorder([], path, k), s, specs, lane_off, lane_lo, lane_hi,
             pmask, sa, bases, chunk=next(
                 i for i, (cs, cl, _) in enumerate(specs)
                 if cs <= src < cs + cl))
    del codes, lane_lo, lane_hi, pmask, sa
    torch.cuda.empty_cache()
    return rows


def run_big_whole(work: str, mbp: float, device, plain_events: int = 0
                  ) -> list:
    """The ``big_whole`` path (module docstring, step 5); with
    ``plain_events``, a third run with ``ASGART_DEVICE_CHAIN=1`` held to
    the cold run's JSON (:func:`device_chain_run`) and :func:`kn_checks`.
    Returns its kernel rows with their main-path launch counts."""
    import logging

    import torch

    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import INDEX_CACHE, free_bytes
    from asgart_tpu_torch.pipeline import (plan_shards, plan_windows,
                                           search_duplications)
    from asgart_tpu_torch.structs import RunSettings

    path, k = "big_whole", 20
    tag = f"{path} k={k}"
    fa = os.path.join(work, "big.fa")
    t0 = time.time()
    meta = big_genome(fa, mbp)
    print(f"{tag} genome: {meta['n']} bp in {meta['records']} records "
          f"(seed {SEED}), -RC pair {meta['src']} -> {meta['dst']} "
          f"({PLANT_BP} bp), written in {time.time() - t0:.1f} s",
          flush=True)
    s = RunSettings(probe_size=k, reverse=True, complement=True)
    t0 = time.time()
    _, chunks, strand = prepare_data([fa], False, None)
    n1 = len(strand.data)
    torch.cuda.empty_cache()
    S = plan_shards(n1, k, True, free_bytes(device))
    windows = plan_windows(n1 - 1, S)
    print(f"{tag} parsed in {time.time() - t0:.1f} s: n1={n1} (n1 > 2^31: "
          f"{n1 > 2**31}; doubled {2 * n1 - 1} > 2^31: "
          f"{2 * n1 - 1 > 2**31}), {len(chunks)} chunks, the planner's "
          f"S={S}: {windows}", flush=True)
    gapped_upload_check(tag, strand.data, device)
    rows = big_whole_checks(tag, strand, chunks, s, windows[-1],
                            meta["src"], device)
    largest = mj_peaks(fa, s, windows, device)
    del strand

    class Said(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.lines = []

        def emit(self, rec):
            self.lines.append(rec.getMessage())

    said = Said()
    logging.getLogger("asgart").addHandler(said)
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    kmod.reset_launch_counts()
    runs = {}
    try:
        for tag2 in ("cold", "second"):
            before = kmod.launch_counts()
            prof: dict = {}
            t0 = time.time()
            res = search_duplications([fa], s, engine="cuda", device=device,
                                      profile=prof)
            torch.cuda.synchronize()
            t = time.time() - t0
            after = kmod.launch_counts()
            runs[tag2] = (t, json_text(res), prof,
                          {m: after[m] - before[m] for m in after})
            if tag2 == "cold":
                peak = torch.cuda.max_memory_allocated(device)
        counts = kmod.launch_counts()
    finally:
        logging.getLogger("asgart").removeHandler(said)
    for tag2, (t, text, prof, c) in runs.items():
        print(f"{tag} cuda {tag2}: {t:.3f} s wall, {meta['n'] / 1e6 / t:.2f} "
              f"Mbp/s, phases {json.dumps(prof)}, launches {json.dumps(c)}")
    text = runs["cold"][1]
    sds = [sd for fam in json.loads(text)["families"] for sd in fam]
    print(f"{tag} JSON {len(text)} bytes, {len(sds)} SDs; peak device memory "
          f"of the cold run {peak} B against the largest window build alone "
          f"{largest} B; launches on the main path: {json.dumps(counts)}",
          flush=True)
    if runs["second"][1] != text:
        raise AssertionError(f"{tag}: the second run's JSON differs from "
                             "the cold run's")
    if f"auto-sharding into {S} trim windows" not in " ".join(said.lines):
        raise AssertionError(f"{tag}: the planner did not shard into {S} "
                             f"windows: {said.lines}")
    for tag2, (_, _, _, c) in runs.items():
        want = {"unpack_codes": 1, "pack_keys": S + 1, "mj_ranges": S,
                "mj_directory": S}
        if any(c[m] != v for m, v in want.items()):
            raise AssertionError(f"{tag} {tag2}: launches {c}, expected "
                                 f"{want} for {S} merge-join windows")
    for name in MJ:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} main path")
    for sd in sds:
        for p0, ln in ((sd["global_left_position"], sd["left_length"]),
                       (sd["global_right_position"], sd["right_length"])):
            if not 0 <= p0 < p0 + ln <= n1 - 1:
                raise AssertionError(f"{tag}: SD outside the genome: {sd}")
    src, dst = meta["src"], meta["dst"]
    pair = [sd for sd in sds
            if abs(min(sd["global_left_position"],
                        sd["global_right_position"]) - src) < 1000
            and abs(max(sd["global_left_position"],
                        sd["global_right_position"]) - dst) < 1000
            and sd["reversed"] and sd["complemented"]]
    if not pair:
        raise AssertionError(f"{tag}: the planted -RC pair {src} -> {dst} "
                             "was not found")
    far = max(pair[0]["global_left_position"],
              pair[0]["global_right_position"])
    print(f"{tag} planted pair found: {json.dumps(pair[0])}; its copy at "
          f"{far} {'>' if far >= 2**31 else '<'} 2^31 = {2**31}", flush=True)
    if dst >= 2**31 and far < 2**31:
        raise AssertionError(f"{tag}: the copy past 2^31 came back at {far}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    if plain_events:
        INDEX_CACHE.clear()
        torch.cuda.empty_cache()
        dc_counts, dc_largest, _ = device_chain_run(
            f"device_chain {tag}", lambda prof: search_duplications(
                [fa], s, engine="cuda", device=device, profile=prof), text,
            MJ, device)
        kn_checks(recorder(rows, path, k), f"device_chain {tag}",
                  dc_largest, plain_events)
        rows[-1]["launches"] = dc_counts["chain_bursts"]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows


def search_halvings(keys, bucket_starts, probes, steps: int,
                    prefix_shift: int) -> int:
    """The halvings the JAX loop (KQ's plain version) makes on these
    inputs, both searches together: the lanes still live at each of its
    steps."""
    import torch

    from asgart_tpu_torch.kernels.seed import LO_BITS

    if prefix_shift >= 0:
        prefix = probes >> (prefix_shift + LO_BITS)
        lo0 = bucket_starts[prefix].long()
        hi0 = bucket_starts[prefix + 1].long()
    else:
        lo0 = torch.zeros_like(probes)
        hi0 = torch.full_like(probes, keys.numel())
    total = 0
    for right in (False, True):
        lo, hi = lo0, hi0
        for _ in range(steps):
            live = lo < hi
            total += int(live.sum())
            mid = (lo + hi) >> 1
            key = keys[torch.where(live, mid, 0)]
            go_right = key <= probes if right else key < probes
            lo = torch.where(live & go_right, mid + 1, lo)
            hi = torch.where(live & ~go_right, mid, hi)
    return total


def launched(counts: dict) -> dict:
    return {m: v for m, v in counts.items() if v}


def run_seed_trim(fa: str, device, trim, host: str) -> list:
    """``seed_trim``: ``SearchEngine(strand, settings, trim,
    engine="cuda")``, the entry point that reaches ``DeviceSeedIndex``, at
    k = 20 -RC on the mj_trim window: every chunk in turn, then
    ``_finalize_result``, with every launch counter set to 0 just before
    and read just after; the JSON must be mj_trim's host JSON and KQ the
    only kernel launched. Then, on the largest chunk's probes, KQ against
    its plain version and two ``torch.searchsorted`` calls, and KS against
    its plain version and the host pack (``_pack_probe_kmers`` +
    ``split_planes``). Returns KQ's and KS's rows (KS: no launch on the
    path, since the engine packs its probes on the host)."""
    import numpy as np
    import torch

    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.index import CODE
    from asgart_tpu_torch.kernels.seed import (_extremes, equal_range_plain,
                                               equal_range_reads,
                                               launch_equal_range,
                                               pack_probe_planes_plain)
    from asgart_tpu_torch.pipeline import (SearchEngine, _finalize_result,
                                           _pack_probe_kmers,
                                           probe_positions,
                                           transform_needle)
    from asgart_tpu_torch.seed import (equal_range, pack_probe_planes,
                                       split_planes)
    from asgart_tpu_torch.structs import RunSettings

    k = 20
    s = RunSettings(probe_size=k, trim=trim, reverse=True, complement=True)
    tag = f"seed_trim k={k}"
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    kmod.reset_launch_counts()
    t0 = time.time()
    trim_, chunks, strand = prepare_data([fa], s.skip_masked, s.trim)
    se = SearchEngine(strand, s, trim_, engine="cuda")
    t_index = time.time() - t0
    families = [fam for c in chunks for fam in se.run_chunk(c)]
    torch.cuda.synchronize()
    t_scan = time.time() - t0 - t_index
    text = json_text(_finalize_result(families, strand, s))
    wall = time.time() - t0
    counts = kmod.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    dsi = se._device
    print(f"{tag} SearchEngine(engine='cuda') on the window {trim}: "
          f"{wall:.3f} s wall (index {t_index:.3f} s: the host GenomeIndex "
          f"and its upload; chunks {t_scan:.3f} s), {len(chunks)} chunks; "
          f"DeviceSeedIndex {dsi.keys.numel()} keys, prefix_bits "
          f"{dsi.prefix_bits}, steps {dsi.steps}; peak device memory {peak} "
          f"B; launches {json.dumps(launched(counts))}", flush=True)
    if text != host:
        raise AssertionError(f"{tag} JSON differs from mj_trim's host JSON "
                             f"({len(text)} vs {len(host)} bytes)")
    if counts["equal_range"] <= 0 or set(launched(counts)) != \
            {"equal_range"}:
        raise AssertionError(f"{tag}: launches {launched(counts)}, "
                             "expected KQ alone")

    rows = []
    record = recorder(rows, "seed_trim", k)
    start, length = max(chunks, key=lambda c: c[1])
    needle = transform_needle(strand.data[start: start + length], True,
                              True)
    is_ = probe_positions(needle, k)
    codes = np.zeros(len(needle) + k, dtype=np.uint8)
    codes[:len(needle)] = CODE[needle]
    t0 = time.time()
    pk = _pack_probe_kmers(codes, is_, k)
    want_hi, want_lo = split_planes(pk)
    t_pack = time.time() - t0
    B, N = len(pk), dsi.keys.numel()
    probes = torch.from_numpy(pk).to(device)
    args = (dsi.keys, dsi.bucket_starts, probes, dsi.steps,
            dsi.prefix_shift)
    kq = lambda: equal_range(*args)  # noqa: E731
    pq = lambda: equal_range_plain(*args)  # noqa: E731
    lq = lambda: (torch.searchsorted(dsi.keys, probes, side="left"),  # noqa: E731
                  torch.searchsorted(dsi.keys, probes, side="right"))
    got = kq()
    err = max_abs_err(got, pq())
    if max_abs_err(got, lq()) != 0:
        raise AssertionError(f"{tag}: torch.searchsorted differs from KQ")
    # the bound: 8 B of probe, 8 B of bucket bounds and 16 B of output a
    # probe, and 8 B a key read, the reads KQ's counting instance makes
    reads, jax_loop = equal_range_reads(*args)
    if jax_loop:
        raise AssertionError(f"{tag}: {jax_loop} probes took the JAX loop "
                             f"at the index's own steps {dsi.steps}")
    halvings = search_halvings(*args)
    old_ms, _ = bound(32 * B + 8 * halvings, 6 * halvings + 4 * B)
    print(f"{tag} KQ's key reads on these probes, counted by the kernel: "
          f"{reads} ({reads / B:.2f} a probe), {jax_loop} probes took the "
          f"JAX loop; the JAX loop's halvings {halvings} "
          f"({halvings / B:.2f} a probe), whose bytes bound the reference "
          f"loop at {old_ms:.4f} ms", flush=True)
    record("equal_range", "seed.cu", "asgart_tpu/seed.py:73", err,
           cuda_ms(kq, FINE_REPS), cuda_ms(pq, FINE_REPS),
           f"{B} probes (chunk {start}+{length}) against {N} keys, "
           f"{1 << dsi.prefix_bits} buckets, steps {dsi.steps}, "
           f"{reads} key reads",
           32 * B + 8 * reads, 6 * reads + 4 * B,
           library_ms=cuda_ms(lq, FINE_REPS),
           alone=(kernel_ms(lambda: launch_equal_range(*args), FINE_REPS),
                  kernel_ms(lq, FINE_REPS)))
    rows[-1]["key_reads"] = reads
    rows[-1]["jax_loop_probes"] = jax_loop
    rows[-1]["launches"] = counts["equal_range"]

    t_codes = torch.from_numpy(codes).to(device)
    pos = torch.from_numpy(is_).to(device)
    ks = lambda: pack_probe_planes(t_codes, pos, k)  # noqa: E731
    ps = lambda: pack_probe_planes_plain(t_codes, pos, k)  # noqa: E731
    got = ks()
    err = max_abs_err(got, ps())
    host_planes = (torch.from_numpy(want_hi).to(device),
                   torch.from_numpy(want_lo).to(device))
    if max_abs_err(got, host_planes) != 0:
        raise AssertionError(f"{tag}: KS differs from the host pack")
    print(f"{tag} host pack of the chunk's {B} probes (_pack_probe_kmers + "
          f"split_planes): {t_pack * 1e3:.3f} ms; KS's bounds check alone "
          f"{cuda_ms(lambda: _extremes(pos)):.3f} ms", flush=True)
    record("pack_probe_planes", "seed.cu", "asgart_tpu/seed.py:47", err,
           cuda_ms(ks), cuda_ms(ps), f"{B} positions of {len(codes)} codes",
           len(codes) + 8 * B + 8 * B, 2 * k * B)
    rows[-1]["launches"] = counts["pack_probe_planes"]
    del se, dsi, args, probes, t_codes, pos, host_planes, got
    torch.cuda.empty_cache()
    return rows


def seed_ballast(n1: int, k: int, device):
    """A tensor on the card that leaves ``fused_index.free_bytes`` midway
    between what the k = 21 route holds (the doubled text's range table,
    8 B per row, and one batch's transfers) and the smaller of the fused
    build's and the table's projections, so that the router takes the
    ``SearchEngine`` route by memory alone."""
    import torch

    from asgart_tpu_torch.fused_index import (
        INDEX_CACHE, PEAK_BYTES_PER_ROW, TABLE_PEAK_BYTES_PER_ROW,
        free_bytes, key_words, projected_rows)
    from asgart_tpu_torch.seed import DEFAULT_BATCH

    n = 2 * n1 - 1
    need = 8 * n + 40 * DEFAULT_BATCH
    limit = min(projected_rows(n1, n1, k) * PEAK_BYTES_PER_ROW[key_words(k)],
                n * TABLE_PEAK_BYTES_PER_ROW)
    if need >= limit:
        raise AssertionError(f"no free memory routes k = {k} to the position "
                             f"tables ({need} >= {limit} B)")
    INDEX_CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = int(free_bytes(device) - (need + limit) // 2)
    print(f"ballast {nbytes} B leaves {(need + limit) // 2} B free: the "
          f"position tables' need {need} B, the fused build's and the "
          f"table's smaller projection {limit} B", flush=True)
    return torch.empty(nbytes, dtype=torch.uint8, device=device), nbytes


def run_seed_k21(fa: str, n: int, device, work: str) -> list:
    """``seed_k21``: the whole genome at k = 21 -RC through
    ``search_duplications(engine="cuda")`` behind a ballast
    (:func:`seed_ballast`) that leaves too little memory for the fused
    build and the table: the JAX package's ``SearchEngine(engine="tpu")``
    route, its range table on the card (KR). The host engine, then a run
    without a journal and a cold journaled run, each with every launch
    counter set to 0 just before and read just after: each JSON must be
    the host engine's and KR the only kernel launched. Then KR's two forms
    against their plain versions and ``ranges[x]`` on the largest chunk's
    ``x`` (taken with the table from the journaled run). Returns KR's
    rows."""
    import torch

    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch import seed
    from asgart_tpu_torch.kernels.seed import (gather_ranges_plain,
                                               launch_gather_ranges)
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.structs import RunSettings

    k = 21
    s = RunSettings(probe_size=k, reverse=True, complement=True)
    tag = f"seed_k21 k={k}"
    t0 = time.time()
    host = json_text(search_duplications([fa], s, engine="host"))
    print(f"{tag} host engine: {time.time() - t0:.3f} s wall", flush=True)
    journal = os.path.join(work, "seed_k21.journal")
    if os.path.exists(journal):
        os.remove(journal)
    gather = seed.DevicePositionTables.gather_ranges
    largest = {}

    def spy(self, x):  # the journaled run's largest x, and its table
        if len(x) > len(largest.get("x", ())):
            largest.update(x=x.copy(), ranges=self.ranges)
        return gather(self, x)

    ballast, nb = seed_ballast(n + 1, k, device)
    runs = {}
    try:
        for tag2, ck in (("cold", None), ("journaled", journal)):
            if ck is not None:
                seed.DevicePositionTables.gather_ranges = spy
            torch.cuda.reset_peak_memory_stats(device)
            kmod.reset_launch_counts()
            prof: dict = {}
            t0 = time.time()
            res = search_duplications([fa], s, engine="cuda", device=device,
                                      checkpoint=ck, profile=prof)
            torch.cuda.synchronize()
            runs[tag2] = (time.time() - t0, json_text(res), prof,
                          kmod.launch_counts(),
                          torch.cuda.max_memory_allocated(device) - nb)
    finally:
        seed.DevicePositionTables.gather_ranges = gather
        del ballast
    for tag2, (t, text, prof, counts, peak) in runs.items():
        print(f"{tag} cuda {tag2}: {t:.3f} s wall, {n / 1e6 / t:.2f} Mbp/s, "
              f"phases {json.dumps(prof)}, peak device memory {peak} B "
              f"(ballast excluded), launches {json.dumps(launched(counts))}",
              flush=True)
        if text != host:
            raise AssertionError(f"{tag} cuda {tag2} JSON differs from the "
                                 f"host engine's ({len(text)} vs "
                                 f"{len(host)} bytes)")
        if counts["gather_ranges"] <= 0 or set(launched(counts)) != \
                {"gather_ranges"}:
            raise AssertionError(f"{tag} {tag2}: launches "
                                 f"{launched(counts)}, expected KR alone")

    rows = []
    x = torch.from_numpy(largest.pop("x")).to(device)
    ranges = largest.pop("ranges")
    B, nr = x.numel(), ranges.shape[0]
    pos_lo, pos_hi = ranges[:, 0].contiguous(), ranges[:, 1].contiguous()
    for form, src, gather_fn, lib in (
            ("rows", (ranges[:, 0], ranges[:, 1]),
             lambda: seed._gather_range_rows(ranges, x),
             lambda: ranges[x]),
            ("planar", (pos_lo, pos_hi),
             lambda: seed._gather_tables(pos_lo, pos_hi, x),
             lambda: (pos_lo[x], pos_hi[x]))):
        got = gather_fn()
        err = max_abs_err(got, gather_ranges_plain(*src, x))
        want = lib()
        if form == "rows":
            want = (want[:, 0], want[:, 1])
        if max_abs_err(got, want) != 0:
            raise AssertionError(f"{tag}: indexing differs from KR "
                                 f"({form})")
        record = recorder(rows, "seed_k21" if form == "rows"
                          else "seed_k21 planar", k)
        record("gather_ranges", "seed.cu", "asgart_tpu/seed.py:125"
               if form == "rows" else "asgart_tpu/seed.py:120", err,
               cuda_ms(gather_fn, FINE_REPS), cuda_ms(
                   lambda: gather_ranges_plain(*src, x), FINE_REPS),
               f"{B} indices into {nr} rows ({form})", 32 * B, 2 * B,
               library_ms=cuda_ms(lib, FINE_REPS),
               alone=(kernel_ms(lambda: launch_gather_ranges(*src, x),
                                FINE_REPS), kernel_ms(lib, FINE_REPS)))
        rows[-1]["launches"] = runs["cold"][3]["gather_ranges"]
    del x, ranges, pos_lo, pos_hi, got, want
    torch.cuda.empty_cache()
    return rows


def run_hosts(fa: str, device, work: str, host: str) -> None:
    """``hosts``: the CLI with ``--shards 4 --hosts 2 --engine cuda``: the
    four windows as worker processes of the port's CLI, two at a time on
    this one card (each sizes its route from the free memory it finds at
    its start); the JSON must be the shards path's host JSON. Prints the
    wall and the workers' device memory: each new process's peak as
    ``nvidia-smi`` lists it, and the card's peak use above what it held
    before the workers started, sampled every 0.2 s."""
    import threading

    import torch

    from asgart_tpu_torch.cli.main import main as cli_main
    from asgart_tpu_torch.fused_index import INDEX_CACHE

    tag = "hosts k=20"
    INDEX_CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = os.path.join(work, "hosts.json")

    def apps() -> dict:
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                            "used_memory", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        fields = ([f.strip() for f in line.split(",")]
                  for line in r.stdout.splitlines())
        return {int(f[0]): int(f[1]) for f in fields
                if len(f) == 2 and f[0].isdigit() and f[1].isdigit()}

    before = apps()
    free, total = torch.cuda.mem_get_info(device)
    base = total - free
    seen: dict = {}
    peak = [0]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            for pid, mib in apps().items():
                if pid not in before:
                    seen[pid] = max(seen.get(pid, 0), mib)
            f, _ = torch.cuda.mem_get_info(device)
            peak[0] = max(peak[0], total - f - base)
            stop.wait(0.2)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.time()
    try:
        rc = cli_main([fa, "-R", "-C", "--shards", str(SHARDS), "--hosts",
                       "2", "--engine", "cuda", "--out", out])
    finally:
        stop.set()
        sampler.join()
    wall = time.time() - t0
    with open(out) as fh:
        text = fh.read() if rc == 0 else ""
    per_pid = json.dumps(seen) if seen else "none listed (nvidia-smi " \
        "shows no process of this container)"
    print(f"{tag} --shards {SHARDS} --hosts 2 --engine cuda (CLI): {wall:.3f}"
          f" s wall, rc {rc}; each worker's peak (nvidia-smi, MiB by pid): "
          f"{per_pid}; the card's peak above its use before the workers "
          f"(two workers at a time) {peak[0]} B", flush=True)
    if rc != 0:
        raise AssertionError(f"{tag}: the CLI exited {rc}")
    if text != host:
        raise AssertionError(f"{tag} JSON differs from the shards path's "
                             f"host JSON ({len(text)} vs {len(host)} bytes)")
    if peak[0] <= 0:
        raise AssertionError(f"{tag}: no worker held device memory")


RANK_KERNELS = ("pack_keys", "mj_ranges", "mj_directory", "gather_owned",
                "scan_core")
PROBE_KERNELS = ("table_ranges", "scan_core")
WINDOW_KERNELS = ("pack_keys", "mj_ranges", "mj_directory", "scan_core")
MESH_KERNELS = WINDOW_KERNELS + ("gather_flat",)  # KP: the probe-axis merge
MESH_RANKS = 8  # mesh_shards: 8 ranks at --shards 4, the (4, 2) mesh


def kt_check(fa: str, settings, device, D: int) -> list:
    """KT ``gather_owned`` against its plain version on each of ``D``
    ranks' shards of the window, on the largest chunk's lanes (by raw
    total) with the global bounds of a one-rank stage 1 (the bounds every
    rank holds after stage 1's ``all_reduce``); both timed, with the bound
    of the bytes the function needs: lo, hi and mask of every lane (9 B),
    the offset of every lane that has entries (8 B), 4 B per buffer entry
    written and 4 B per owned entry read; two operations per entry. With
    D = 1 the shard is the index the run left in the cache (a hit:
    nothing is rebuilt, and stage 1 is the one kept on the index); with D
    > 1 rank r's shard is ``ShardedWindowIndex.build(..., r, D)`` on the
    card (the whole window, then cut: the rows the host build gives rank
    r, bit for bit). Returns one result a rank."""
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import ShardedWindowEngine
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.kernels import gather_owned
    from asgart_tpu_torch.kernels.sharded import (csr_offsets,
                                                  gather_owned_plain)
    from asgart_tpu_torch.window_index import ShardedWindowIndex

    s = settings
    trim, chunks, strand = prepare_data([fa], s.skip_masked, s.trim)
    eng = ShardedWindowEngine(strand, s, device, trim)
    idx = eng.ensure_index()
    ranges = eng.stage1(chunks)
    n_lanes = {(cs, cl): nc for cs, cl, nc in ranges.specs}
    chunk = max(n_lanes, key=lambda c: ranges.offs[c][1])
    off0, _ = ranges.offs[chunk]
    lanes = [t[off0: off0 + n_lanes[chunk]] for t in
             (ranges.lane_lo, ranges.lane_hi, ranges.lane_mask)]
    off, total = csr_offsets(*lanes)
    lo, hi = (t.to(torch.int64) for t in lanes[:2])
    live = int(((hi > lo) & lanes[2]).sum())  # lanes with entries
    codes = None if D == 1 else upload_codes(strand.data, device)
    checks = []
    for r in range(D):
        shard = idx if D == 1 else ShardedWindowIndex.build(
            strand.data, s.probe_size, trim, s.reverse, s.complement,
            device, r, D, False, codes)
        args = (*lanes, off, total, shard.sa, shard.row0)
        got = gather_owned(*args)
        want = gather_owned_plain(*args)
        torch.cuda.synchronize()
        span = (hi.clamp(max=shard.row0 + shard.sa.numel())
                - lo.clamp(min=shard.row0)).clamp(min=0)
        owned = int(torch.where(lanes[2], span, 0).sum())
        checks.append({
            "chunk": list(chunk), "lanes": n_lanes[chunk], "live": live,
            "total": total, "owned": owned,
            "rows": [shard.row0, shard.sa.numel()],
            "max_abs_err": max_abs_err([got], [want]),
            "ms": cuda_ms(lambda: gather_owned(*args)),
            "alone": kernel_ms(lambda: gather_owned(*args), FINE_REPS),
            "plain_ms": cuda_ms(lambda: gather_owned_plain(*args)),
            "nbytes": 9 * n_lanes[chunk] + 8 * live + 4 * total
            + 4 * owned, "ops": 2 * total})
        del shard, args, got, want
    return checks


def kt_row(record, check: dict, tag: str) -> None:
    """A KT row from :func:`kt_check`'s result."""
    record("gather_owned", "sharded.cu",
           "asgart_tpu/device_engine.py:3180 (sa_gather of "
           "_sharded_window_core_fn)", check["max_abs_err"], check["ms"],
           check["plain_ms"],
           f"{tag}: {check['lanes']} lanes ({check['live']} with entries), "
           f"{check['total']} entries, {check['owned']} owned (rows "
           f"{check['rows'][0]}.."
           f"+{check['rows'][1]})", check["nbytes"], check["ops"],
           alone=(check["alone"], None))


def collective_summary(stats) -> str:
    """Each collective's bytes and milliseconds, in order."""
    return ", ".join(f"{op} {b} B {ms:.3f} ms" for op, b, ms in stats)


def run_rank_trim(fa: str, n: int, device, trim, host: str) -> list:
    """``rank_trim``: a one-rank NCCL group on the card, and
    ``ASGART_RANK_SHARDED=1`` behind :func:`mj_ballast` (no fused build
    fits), so that the router takes ``ShardedWindowEngine`` on the mj_trim
    window (k = 20, -RC; built on the card, as the merge join fits): a
    cold run and a warm one (an index cache hit: no KA, no KH), with every
    launch counter set to 0 just before and read just after; the JSON must
    be mj_trim's host JSON and KA, KH, KT and KD launched; every
    ``all_reduce`` (stage 1's three, then one per chunk) printed; then KT
    against its plain version on the largest chunk."""
    import torch

    from asgart_tpu_torch import distributed
    from asgart_tpu_torch import kernels as kmod
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.structs import RunSettings

    s = RunSettings(probe_size=20, trim=trim, reverse=True, complement=True)
    tag = "rank_trim k=20"
    distributed.init(0, 1, device, f"tcp://127.0.0.1:{free_port()}",
                     "nccl")
    os.environ["ASGART_RANK_SHARDED"] = "1"
    ballast, nb = mj_ballast(n + 1, trim[1] - trim[0] + 1, 20, False, device)
    try:
        rows = []
        runs = {}
        torch.cuda.reset_peak_memory_stats(device)
        kmod.reset_launch_counts()
        for tag2 in ("cold", "warm"):
            before = kmod.launch_counts()
            del distributed.stats[:]
            t0 = time.time()
            res = search_duplications([fa], s, engine="cuda", device=device)
            torch.cuda.synchronize()
            t = time.time() - t0
            after = kmod.launch_counts()
            runs[tag2] = (t, json_text(res), launched(
                {m: after[m] - before[m] for m in after}),
                list(distributed.stats))
        counts = kmod.launch_counts()
        peak = torch.cuda.max_memory_allocated(device) - nb
        check, = kt_check(fa, s, device, 1)
    finally:
        del ballast
        os.environ.pop("ASGART_RANK_SHARDED")
        distributed.dist.destroy_process_group()
    for tag2, (t, text, c, st) in runs.items():
        print(f"{tag} cuda {tag2}: {t:.3f} s wall, launches {json.dumps(c)}"
              f"; backend nccl, 1 rank: {collective_summary(st)}")
        if text != host:
            raise AssertionError(f"{tag} {tag2} JSON differs from mj_trim's "
                                 f"host JSON ({len(text)} vs {len(host)} "
                                 "bytes)")
    print(f"{tag} peak device memory {peak} B (ballast excluded)",
          flush=True)
    for name in RANK_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} main path")
    if runs["warm"][2].get("pack_keys") or runs["warm"][2].get("mj_ranges") \
            or runs["warm"][2].get("mj_directory"):
        raise AssertionError(f"{tag} warm run (a cache hit) launched KA, "
                             "KH or KH's directory")
    kt_row(recorder(rows, "rank_trim", 20), check, "largest chunk, 1 rank")
    rows[-1]["launches"] = counts["gather_owned"]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_reports(tag: str, reports: list, kernels) -> None:
    """Prints each rank's report (walls, launches, peak, collectives) and
    fails when a kernel of the path was not launched on a rank."""
    for rep in reports:
        c = launched(rep["launches"])
        lanes = f", {rep['lanes']} lanes" if "lanes" in rep else ""
        print(f"{tag} rank {rep['rank']} of {rep['world']} ({rep['backend']} "
              f"on {rep['device']}{lanes}): group set-up "
              f"{rep['init_s']:.3f} s, search {rep['search_s']:.3f} s "
              f"(phases {json.dumps(rep['profile'])}), peak "
              f"device memory {rep['peak_bytes']} B, launches "
              f"{json.dumps(c)}; {collective_summary(rep['collectives'])}",
              flush=True)
        for name in kernels:
            if not c.get(name):
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"{tag} rank {rep['rank']}")


def run_rank_trim4(fa: str, trim, host: str) -> list:
    """``rank_trim4``: ``distributed.dryrun`` with 4 gloo ranks sharing the
    card (NCCL refuses two ranks on one GPU) on the mj_trim window with
    ``ASGART_RANK_SHARDED=1`` and the host build
    (``ASGART_RSH_HOST_BUILD=1``): the four JSONs must be identical and
    mj_trim's host JSON, and KA, KH, KT and KD launched on every rank; then,
    in this process once the ranks have ended, KT against its plain version
    on each of the four ranks' shards (:func:`kt_check`)."""
    import torch

    from asgart_tpu_torch import distributed
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.structs import RunSettings

    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    s = RunSettings(probe_size=20, trim=trim, reverse=True, complement=True)
    tag = "rank_trim4 k=20"
    t0 = time.time()
    _, reports = distributed.dryrun(
        4, "cuda:0", fa=fa, settings=s, host=host,
        env={"ASGART_RSH_HOST_BUILD": "1"}, timeout=600)
    print(f"{tag}: 4 ranks, JSON identical and mj_trim's host JSON, "
          f"{time.time() - t0:.3f} s wall", flush=True)
    rank_reports(tag, reports, RANK_KERNELS)
    checks = kt_check(fa, s, torch.device("cuda", 0), 4)
    rows = []
    for rep, check in zip(reports, checks):
        kt_row(recorder(rows, f"rank_trim4 rank {rep['rank']}", 20),
               check, f"largest chunk, rank {rep['rank']} of 4")
        rows[-1]["launches"] = rep["launches"]["gather_owned"]
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    return rows


def run_probe_mesh2(fa: str, host: str) -> None:
    """``probe_mesh2``: ``distributed.dryrun`` with 2 gloo ranks sharing the
    card on the whole genome, k = 20, -RC: under a group the router takes
    no fused build, so the table engine's probe-axis scan; both JSONs must
    be the whole k = 20 path's host JSON, and KM and KD launched on each
    rank; each rank's lanes and every ``all_gather`` printed."""
    import torch

    from asgart_tpu_torch import distributed
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.structs import RunSettings

    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    tag = "probe_mesh2 k=20"
    t0 = time.time()
    _, reports = distributed.dryrun(
        2, "cuda:0", fa=fa, settings=RunSettings(probe_size=20, reverse=True,
                                                 complement=True),
        host=host, timeout=600)
    print(f"{tag}: 2 ranks, JSON identical and the whole path's host JSON, "
          f"{time.time() - t0:.3f} s wall", flush=True)
    rank_reports(tag, reports, PROBE_KERNELS)


def mesh_checks(fa: str, settings, device, w: int, P: int,
                reports: list) -> list:
    """The kernels of mesh_shards' cells (w, 0..P-1) against their plain
    versions, in this process once the ranks have ended, at the shapes each
    rank gave them (``MeshWindowEngine`` made for each cell's rank, its
    window built on the card): KA's probe-only pack of every chunk's lanes
    and KH against window w's keys (what every rank of window w runs), then
    KD on each cell's lanes of the largest chunk, with j0 at the cell's
    first lane and the rebased constants; then KP, which merges those P
    cells' results in p order as every rank does after the gather
    (``merge_slices``), against its plain version and ``torch.take``. Each
    row's launches are the launches of the rank of that cell (for KA, KH
    and KP, cell (w, 0)) on the main path."""
    import torch

    from asgart_tpu_torch.device_engine import (MeshWindowEngine,
                                                chunk_specs, merged_index,
                                                probe_lanes, rebased_bases)
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.kernels import gather_flat, pack_keys
    from asgart_tpu_torch.kernels.slices import gather_flat_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.pipeline import plan_windows

    s = settings
    k, rc = s.probe_size, (s.reverse, s.complement)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    n1 = len(strand.data)
    windows = plan_windows(n1 - 1, SHARDS)
    eng = MeshWindowEngine(strand, s, device, windows, r=w * P,
                           D=SHARDS * P, cache=None)
    idx = eng.ensure_index()
    ws, W = eng.trim[0], idx.W
    specs = chunk_specs(chunks, s)
    tabs = chunk_tables(specs, n1, k, *rc)
    lane_off = tabs[0]
    total = lane_off[-1]
    codes = eng._codes()
    rows = []
    record = recorder(rows, "mesh_shards", k)
    r0 = reports[w * P]["launches"]

    kap = lambda: pack_keys(codes, specs, k, *rc, 0, total)  # noqa: E731
    pap = lambda: pack_keys_plain(codes, *tabs, k, *rc, 0, total)  # noqa: E731
    (pkey,), pmask = kap()
    want_key, want_mask = pap()
    err = max_abs_err((pkey, pmask), (*want_key, want_mask))
    del want_key, want_mask
    record("pack_keys", "pack_keys.cu", "asgart_tpu/device_engine.py:2817 "
           "(_mesh_ranges_batch's _pack_batch_probe_keys :904; :2788 one "
           "chunk)", err, cuda_ms(kap, FINE_REPS), cuda_ms(pap),
           f"cell ({w}, 0): {total} probe keys, probe-only", n1 + 9 * total,
           total * (4 * k + 8), alone=(kernel_ms(kap, FINE_REPS), None))
    rows[-1]["launches"] = r0["pack_keys"]

    lane_lo, lane_hi, _ = kh_checks(
        record, "mesh_shards k=20", idx.key, k, pkey, pmask, lane_off,
        "asgart_tpu/device_engine.py:2817 (_mesh_ranges_batch's _mj_tail "
        ":788; :2788 one chunk)", f"cell ({w}, 0)")
    rows[-2]["launches"] = r0["mj_directory"]
    rows[-1]["launches"] = r0["mj_ranges"]
    del pkey

    parts = []
    for p in range(P):  # cell (w, p)'s lanes, as its rank's part()
        parts.append(kd_check(
            record, s, specs, lane_off, lane_lo, lane_hi, pmask, idx.sa,
            lambda cs, cl: rebased_bases(cs, cl, ws, W),
            part=lambda nc, p=p: probe_lanes(nc, p, P),
            replaces="asgart_tpu/device_engine.py:2847 "
            "(_mesh_window_core_off; :2877 _mesh_window_core)"))
        rows[-1]["launches"] = reports[w * P + p]["launches"]["scan_core"]
        rows[-1]["path"] = f"mesh_shards cell ({w}, {p})"

    # KP on the P cells' results of the largest chunk, in p order
    idx_m = merged_index(parts)
    srcs = [c.flat for c in parts]
    kp = lambda: gather_flat(srcs, idx_m)  # noqa: E731
    pp = lambda: gather_flat_plain(srcs, idx_m)  # noqa: E731
    err = max_abs_err((kp(),), (pp(),))
    src = torch.cat(srcs)
    lib = lambda: torch.take(src, idx_m)  # noqa: E731
    if not torch.equal(lib(), kp()):
        raise AssertionError("torch.take differs from KP on mesh_shards")
    m = idx_m.numel()
    record("gather_flat", "slices.cu", "asgart_tpu/device_engine.py:3091 "
           "(_chain_cells' _merge_shard_events :1082; :1112 _gather_flat)",
           err, cuda_ms(kp, FINE_REPS), cuda_ms(pp, FINE_REPS),
           f"window {w}'s {P} cells of the largest chunk: {m} entries from "
           f"{src.numel()} int32", 12 * m + 4 * src.numel(), m,
           library_ms=cuda_ms(lib, FINE_REPS),
           alone=(kernel_ms(kp, FINE_REPS), kernel_ms(lib, FINE_REPS)))
    rows[-1]["launches"] = r0["gather_flat"]
    rows[-1]["path"] = f"mesh_shards window {w}"
    merge_ms(f"mesh_shards window {w}", parts)
    del eng, idx, codes, parts, srcs, src, idx_m
    torch.cuda.empty_cache()
    return rows


def run_mesh_shards(fa: str, host: str) -> list:
    """``mesh_shards``: ``distributed.dryrun`` with 8 gloo ranks sharing the
    card at ``--shards 4`` (k = 20, -RC): the windows x probes mesh (4, 2),
    the shape the JAX package takes for ``--shards 4`` on 8 devices. The
    eight JSONs must be identical and the shards path's host JSON, and
    KA, KH, KD and KP launched on every rank; each rank's cell, window and
    lanes per chunk, its collectives, peak and wall are printed; then
    :func:`mesh_checks` on window 2's cells."""
    import torch

    from asgart_tpu_torch import distributed
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.structs import RunSettings

    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    s = RunSettings(probe_size=20, reverse=True, complement=True)
    tag = "mesh_shards k=20"
    t0 = time.time()
    _, reports = distributed.dryrun(MESH_RANKS, "cuda:0", fa=fa, settings=s,
                                    host=host, timeout=600, shards=SHARDS)
    print(f"{tag}: {MESH_RANKS} ranks at --shards {SHARDS}, JSON identical "
          f"and the shards path's host JSON, {time.time() - t0:.3f} s wall",
          flush=True)
    rank_reports(tag, reports, MESH_KERNELS)
    P = MESH_RANKS // SHARDS
    for r, rep in enumerate(reports):
        cell = rep["profile"]["mesh"]
        if (cell["S"], cell["P"], cell["w"], cell["p"]) != \
                (SHARDS, P, r // P, r % P):
            raise AssertionError(f"{tag} rank {r} ran cell {cell}")
    return mesh_checks(fa, s, torch.device("cuda", 0), SHARDS // 2, P,
                       reports)


def run_seq_shards3(fa: str, host: str) -> None:
    """``seq_shards3``: ``distributed.dryrun`` with 3 gloo ranks sharing the
    card at ``--shards 4`` (k = 20, -RC): 4 windows do not tile 3 ranks,
    so the windows run one after another, each on every rank's merge-join
    engine (no fused build under a group); the three JSONs must be the
    shards path's host JSON, and KA, KH and KD launched on every rank."""
    import torch

    from asgart_tpu_torch import distributed
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.structs import RunSettings

    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    tag = "seq_shards3 k=20"
    t0 = time.time()
    _, reports = distributed.dryrun(
        3, "cuda:0", fa=fa, settings=RunSettings(probe_size=20, reverse=True,
                                                 complement=True),
        host=host, timeout=600, shards=SHARDS)
    print(f"{tag}: 3 ranks at --shards {SHARDS}, the windows in turn, JSON "
          f"identical and the shards path's host JSON, "
          f"{time.time() - t0:.3f} s wall", flush=True)
    rank_reports(tag, reports, WINDOW_KERNELS)
    if any("mesh" in rep["profile"] for rep in reports):
        raise AssertionError(f"{tag} ran the mesh engine")


def run_group_journal2(fa: str, work: str, host: str) -> None:
    """``group_journal2``: ``distributed.dryrun`` with 2 gloo ranks sharing
    the card on the whole genome (k = 20, -RC) with ``--checkpoint``: the
    table engine's probe-axis scan, rank 0 the journal's one writer. A cold
    run, then one resumed from the journal cut to its header and first
    chunk; both JSONs must be the whole path's host JSON, KM and KD
    launched on each rank of both runs, and the resumed journal the cold
    one."""
    import torch

    from asgart_tpu_torch import distributed
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.structs import RunSettings

    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    s = RunSettings(probe_size=20, reverse=True, complement=True)
    journal = os.path.join(work, "group_journal2.journal")
    if os.path.exists(journal):
        os.remove(journal)
    lines = None
    for run in ("cold", "resumed"):
        if lines is not None:
            with open(journal, "w") as fh:
                fh.write("\n".join(lines[:2]) + "\n")
        tag = f"group_journal2 k=20 {run}"
        t0 = time.time()
        _, reports = distributed.dryrun(2, "cuda:0", fa=fa, settings=s,
                                        host=host, timeout=600,
                                        checkpoint=journal)
        print(f"{tag}: 2 ranks, JSON identical and the whole path's host "
              f"JSON, {time.time() - t0:.3f} s wall", flush=True)
        rank_reports(tag, reports, PROBE_KERNELS)
        with open(journal) as fh:
            now = fh.read().splitlines()
        if lines is not None and now != lines:
            raise AssertionError(f"{tag}: the journal differs from the "
                                 "cold run's")
        lines = now
    print(f"group_journal2: journal of {len(lines) - 1} chunk records",
          flush=True)


NCCL_PAIR = r"""
import sys, datetime, torch, torch.distributed as dist
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        rank=int(sys.argv[1]), world_size=2,
                        timeout=datetime.timedelta(seconds=60))
torch.cuda.set_device(0)
t = torch.ones(4, device="cuda:0")
dist.all_reduce(t)
torch.cuda.synchronize()
print("accepted", t.tolist())
dist.destroy_process_group()
"""


def nccl_shared_card() -> None:
    """Two NCCL ranks on ``cuda:0`` (what ``distributed.dryrun`` avoids by
    taking gloo for ranks that share a card): prints whether NCCL refused
    them, and how."""
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PAIR, str(r), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out after 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    text = "\n".join(outs)
    lines = [ln.strip() for ln in text.splitlines() if "Duplicate GPU" in ln]
    verdict = (f"refused: {lines[0]}" if lines else
               "accepted" if all(p.returncode == 0 for p in procs) else
               f"failed otherwise: {text[-500:]!r}")
    print(f"nccl_shared_card: two NCCL ranks on cuda:0 {verdict} (rc "
          f"{[p.returncode for p in procs]})", flush=True)


def main(argv=None) -> int:
    t_start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mbp", type=float, default=128.0,
                    help="synthetic genome size in Mbp (default 128)")
    ap.add_argument("--repeats-mbp", type=float, default=REPEATS_MBP,
                    help="table_repeats genome size in Mbp (default "
                    f"{REPEATS_MBP:g})")
    ap.add_argument("--big-mbp", type=float, default=3100.0,
                    help="big_whole genome size in Mbp: at least 1100 (the "
                    "doubled text past 2^31), or 0 to skip the phase "
                    "(default 3100, a whole human genome)")
    ap.add_argument("--plain-events", type=int, default=PLAIN_EVENTS,
                    help="events of the bursts on which KN is held to its "
                    f"plain version (default {PLAIN_EVENTS})")
    args = ap.parse_args(argv)
    if args.big_mbp and args.big_mbp < 1100:
        ap.error("--big-mbp must be 0 or at least 1100")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.synthetic import synthetic_genome

    card = smi_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    device = cuda_device()

    t0 = time.time()
    _build.lib()
    nvcc = ("already built" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.1f} s")
    print(f"kernel library {os.path.relpath(_build.library_path(), HERE)}: "
          f"{nvcc}, build + load {time.time() - t0:.1f} s", flush=True)

    n = int(args.mbp * 1e6)
    t0 = time.time()
    g = synthetic_genome(n, np.random.default_rng(SEED))
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    fa = os.path.join(work, "genome.fa")
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + g.tobytes() + b"\n")
    print(f"genome: {n} bp synthetic (seed {SEED}) in "
          f"{time.time() - t0:.1f} s", flush=True)
    gapped_upload_check("genome", g, device)
    del g

    def timed(name, fn):
        """``fn()``, its seconds printed as the phase ``name``'s."""
        t0 = time.time()
        out = fn()
        print(f"{name}: phase {time.time() - t0:.1f} s", flush=True)
        return out

    rc = dict(reverse=True, complement=True)
    rows = []
    for k in (20, 25):  # one-word and two-word sort keys
        path_rows, path_host = timed(f"whole k={k}", lambda: run_path(
            fa, n, device, "whole", RunSettings(probe_size=k, **rc)))
        rows += path_rows
        if k == 20:
            whole_host = path_host
            rows += timed("device_chain whole", lambda: run_device_chain_whole(
                fa, device, path_host, args.plain_events))
            rows += timed("whole_sliced", lambda: run_whole_sliced(
                fa, device, path_host))
    shard_rows, shard_host = timed("shards", lambda: run_path(
        fa, n, device, "shards", RunSettings(probe_size=20, **rc),
        shards=SHARDS))
    rows += shard_rows
    # a quarter of the genome around its middle (its N run), two-word
    # keys; at the default size it holds planted -RC pairs (a quick run's
    # smaller genome may have none there)
    trim = (3 * n // 8, 5 * n // 8)
    min_sds = 1 if args.mbp >= 100 else 0
    rows += timed("trim", lambda: run_path(
        fa, n, device, "trim", RunSettings(probe_size=25, trim=trim, **rc),
        min_sds=min_sds))[0]
    # the merge-join window engine, routed there by a ballast tensor: the
    # same middle window at k = 20, and the shards path's windows, whose
    # JSON is the host JSON the fused shards path computed
    mj_rows, mj_host = timed("mj_trim", lambda: run_mj_path(
        fa, n, device, "mj_trim", RunSettings(probe_size=20, trim=trim,
                                              **rc), min_sds=min_sds))
    rows += mj_rows
    rows += timed("mj_shards", lambda: run_mj_path(
        fa, n, device, "mj_shards", RunSettings(probe_size=20, **rc),
        shards=SHARDS, host=shard_host, plain_events=args.plain_events))[0]
    # the route past int32 addressing (no fused build) on the same windows,
    # held to the host JSON of the mj_trim and shards paths
    rows += timed("big_trim", lambda: run_mj_path(
        fa, n, device, "big_trim", RunSettings(probe_size=20, trim=trim,
                                               **rc),
        host=mj_host, min_sds=min_sds, big=True))[0]
    rows += timed("big_shards", lambda: run_mj_path(
        fa, n, device, "big_shards", RunSettings(probe_size=20, **rc),
        shards=SHARDS, host=shard_host, big=True))[0]
    # the seed lookups of SearchEngine(engine="cuda"): a trim window's
    # DeviceSeedIndex (KQ; KS on its largest chunk), held to mj_trim's host
    # JSON; the k = 21 route's position tables (KR); then --hosts on this
    # card, held to the shards path's host JSON
    for name, phase in (
            ("seed_trim", lambda: run_seed_trim(fa, device, trim, mj_host)),
            ("seed_k21", lambda: run_seed_k21(fa, n, device, work)),
            ("hosts", lambda: run_hosts(fa, device, work, shard_host)),
            # the mesh engines on torch.distributed: one NCCL rank, then
            # gloo ranks sharing this card (NCCL refuses that)
            ("rank_trim", lambda: run_rank_trim(fa, n, device, trim,
                                                mj_host)),
            ("rank_trim4", lambda: run_rank_trim4(fa, trim, mj_host)),
            ("probe_mesh2", lambda: run_probe_mesh2(fa, whole_host)),
            # the windows x probes mesh, the windows in turn on every rank,
            # and a journal on ranks
            ("mesh_shards", lambda: run_mesh_shards(fa, shard_host)),
            ("seq_shards3", lambda: run_seq_shards3(fa, shard_host)),
            ("group_journal2", lambda: run_group_journal2(fa, work,
                                                          whole_host)),
            ("nccl_shared_card", nccl_shared_card)):
        rows += timed(name, phase) or []
    # --checkpoint on the table engine: one-word and two-word keys, then a
    # repeat-dense genome whose first tied count passes the default
    # tied_cap (full rounds)
    for k in (20, 25):
        name = "table" if k == 20 else "table_k25"
        rows += timed(name, lambda: run_table_path(
            fa, n, device, name, RunSettings(probe_size=k, **rc), work,
            min_sds=min_sds))
    nr = int(args.repeats_mbp * 1e6)
    t0 = time.time()
    rfa = os.path.join(work, "repeats.fa")
    with open(rfa, "wb") as fh:
        fh.write(b">chr1\n" + repeat_genome(nr).tobytes() + b"\n")
    print(f"repeats genome: {nr} bp (seed {SEED}) in "
          f"{time.time() - t0:.1f} s", flush=True)
    # its runs are the host chain's (~40 s each): no journal-free run;
    # then the device chain's journaled run
    rows += timed("table_repeats", lambda: run_table_path(
        rfa, nr, device, "table_repeats", RunSettings(probe_size=20, **rc),
        work,
        # and KE's sizing pass: its subset rounds' tied set passes
        # ties.SIZING_MIN
        kernels=TABLE + FULL_ROUNDS + ("tie_groups",),
        min_tied=(2 * (nr + 1) - 1) // 8, journal_free=False,
        plain_events=args.plain_events))
    if args.big_mbp:
        rows += timed("big_whole", lambda: run_big_whole(
            work, args.big_mbp, device, args.plain_events))
    assert "jax" not in sys.modules
    assert not [m for m in sys.modules
                if m == "asgart_tpu" or m.startswith("asgart_tpu.")]

    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
