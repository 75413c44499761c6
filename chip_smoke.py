"""GPU smoke run of the PyTorch / CUDA port (asgart_tpu_torch) on one card.

    python3 chip_smoke.py            # the full run: 128 Mbp, -RC, four paths
    python3 chip_smoke.py --mbp 4    # a quick run at a smaller genome

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from asgart_tpu_torch/csrc with nvcc;
3. runs four paths on ``asgart_tpu_torch.synthetic.synthetic_genome``
   (the repo benchmark's genome, fixed seed) written as
   FASTA, all -RC: the whole genome at k = 20 (one-word keys) and k = 25
   (two-word keys); ``--shards 4`` at k = 20; and one trim window in the
   middle of the genome at k = 25. For each path:
   a. runs each kernel of the path and its plain PyTorch version on the
      card, on that path's arrays (the fused build of the genome, or of
      window 2 of the shards, or of the trim window, and its largest
      chunk's scan; KE/KF on the first, largest tie round; KG on the
      window's final suffix order), requires equal outputs (tolerance 0:
      all integers), times both with CUDA events after a warm-up, and
      gives each kernel its bound (the larger of its bytes over the HBM
      rate and its integer operations over the non-tensor-core rate) and
      the time of one PyTorch call that computes the same function, where
      one exists; times the key sort and the whole tie resolution with
      KE/KF against the same rounds on their plain versions;
   b. the sharded path measures each window's build peak per fused row;
   c. runs the host engine once (the first run also builds the native
      chain library, which the timed runs then find built);
   d. drives the path through the user entry point
      ``asgart_tpu_torch.pipeline.search_duplications(engine="cuda")``
      twice (whole genome and trim: cold, then a device index cache hit;
      shards: two full runs, the windows are not cached), with every
      launch counter set to 0 just before and read just after; requires
      the JSON bytes of all three runs to be equal and every kernel of
      the path to have been launched;
4. prints a {"kernels": [...]} line (each kernel once per path, with the
   path's name and k), the card again, and last {"ok": true, ...}.

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
SHARDS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12      # H100 SXM non-tensor-core rate (data sheet)
WHOLE = ("pack_keys", "group_bounds", "invert_fused", "tie_keys",
         "tie_refine", "scan_core")
WINDOW = WHOLE + ("offset_slots",)  # KG runs when the window starts > 0


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


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching integer outputs; raises when the
    shapes differ (outputs of different sizes are not equal)."""
    import torch

    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        if a.numel():
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
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
    import torch

    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import fused_layout, sort_keys
    from asgart_tpu_torch.host_helpers import _strand_fingerprint
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          offset_slots, pack_keys,
                                          scan_core, tie_keys, tie_refine)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain
    from asgart_tpu_torch.kernels.ties import (tie_keys_plain,
                                               tie_refine_plain)
    from asgart_tpu_torch.kernels.window import offset_slots_plain

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

    def record(name, src, replaces, err, ms, plain_ms, shape, nbytes, ops,
               library_ms=None):
        bound_ms, bound_by = bound(nbytes, ops)
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        print(f"{tag} kernel {name}: max_abs_err={err} kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}: {nbytes:.0f} B, {ops:.0f} ops), library "
              f"{lib} at {shape}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {tag} (max_abs_err {err})")
        rows.append({"name": name, "path": path, "k": k, "route": "cuda",
                     "source": f"asgart_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})

    t0 = time.time()
    _strand_fingerprint(strand.data)
    t_fp = time.time() - t0
    t0 = time.time()
    codes = upload_codes(strand.data, device)
    torch.cuda.synchronize()
    print(f"{tag} host side of a build: strand fingerprint {t_fp:.3f} s, "
          f"codes LUT + pinned upload {time.time() - t0:.3f} s (host clock)")
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
    record("pack_keys", "pack_keys.cu", replaces, err, cuda_ms(ka),
           cuda_ms(kp), f"M={M}, W={W}, ws={ws}, {words} key words",
           n1 + M * kwb + total, M * (4 * k + 8))
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
           err, cuda_ms(kc), cuda_ms(pc), f"M={M}",
           12 * M + total + 4 * W + 8 * total, 10 * M)
    del run_lo, run_hi

    # KE / KF on the first tie round (the largest tied set); KF writes sa
    # and rank in place, so each side gets its own copies (KF reads
    # neither, so repeated calls write the same values)
    slots = torch.nonzero(tied).flatten()
    n_tied = slots.numel()
    if n_tied == 0:
        raise AssertionError(f"no tied rows on {tag}: KE/KF unchecked")
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(torch.int32)
    h = min(k, M)
    bad_k = torch.zeros(1, dtype=torch.int32, device=device)
    bad_p = torch.zeros(1, dtype=torch.int32, device=device)
    ke = lambda: tie_keys(ps, prims, rank, h, bad_k)  # noqa: E731
    pe = lambda: tie_keys_plain(ps, prims, rank, h, bad_p)  # noqa: E731
    key = ke()
    err = max_abs_err((key, bad_k), (pe(), bad_p))
    record("tie_keys", "ties.cu", "asgart_tpu/device_index.py:696", err,
           cuda_ms(ke), cuda_ms(pe), f"{n_tied} tied entries", 20 * n_tied,
           8 * n_tied)
    skey, order = torch.sort(key, stable=True)
    del key
    sa_k, rank_k, sa_p, rank_p = sa.clone(), rank.clone(), sa.clone(), \
        rank.clone()
    kf = lambda: tie_refine(skey, order, slots, ps, sa_k, rank_k)  # noqa: E731
    pf = lambda: tie_refine_plain(skey, order, slots, ps,  # noqa: E731
                                  sa_p, rank_p)
    got, want = kf(), pf()
    err = max_abs_err((*got, sa_k, rank_k), (*want, sa_p, rank_p))
    record("tie_refine", "ties.cu", "asgart_tpu/device_index.py:696", err,
           cuda_ms(kf), cuda_ms(pf), f"{n_tied} tied entries", 41 * n_tied,
           20 * n_tied)
    del skey, order, sa_k, rank_k, sa_p, rank_p, got, want, ps, prims, slots

    # the whole tie resolution, with KE/KF and with their plain versions
    # in the same rounds, in turns (plain, kernel, kernel, plain)
    def resolve(plain: bool):
        if plain:
            ties_mod.tie_keys, ties_mod.tie_refine = (tie_keys_plain,
                                                      tie_refine_plain)
        try:
            out = sa.clone()
            r = rank.clone()
            torch.cuda.synchronize()
            t0 = time.time()
            ties_mod.resolve_ties(out, r, tied, M, k)
            torch.cuda.synchronize()
            return time.time() - t0, out
        finally:
            ties_mod.tie_keys, ties_mod.tie_refine = tie_keys, tie_refine

    times = {True: [], False: []}
    finals = {}
    for plain in (True, False, False, True):
        t, finals[plain] = resolve(plain)
        times[plain].append(t)
    if not torch.equal(finals[True], finals[False]):
        raise AssertionError(f"tie resolution with KE/KF differs from its "
                             f"plain rounds on {tag}")
    sa = finals[False]
    del finals, rank, tied
    print(f"{tag} tie resolution of {n_tied} tied rows: KE/KF "
          f"{' / '.join(f'{t:.4f}' for t in times[False])} s, plain rounds "
          f"{' / '.join(f'{t:.4f}' for t in times[True])} s (host clock + "
          "sync)", flush=True)

    if ws:
        # KG on the window's final suffix order: kernel, plain version and
        # the one PyTorch call (the plain version is that call), each on
        # its own copy, so every timed launch adds ws to the same values
        copies = [sa.clone() for _ in range(3)]
        kg = lambda: offset_slots(copies[0], ws)  # noqa: E731
        pg = lambda: offset_slots_plain(copies[1], ws)  # noqa: E731
        lg = lambda: copies[2].add_(ws)  # noqa: E731
        err = max_abs_err((kg(),), (pg(),))
        ms, plain_ms, lib_ms = cuda_ms(kg), cuda_ms(pg), cuda_ms(lg)
        record("offset_slots", "window.cu",
               "asgart_tpu/device_index.py:1505", err, ms, plain_ms,
               f"{M} slots, ws={ws}", 8 * M, M, library_ms=lib_ms)
        del copies
        offset_slots(sa, ws)

    # the largest chunk's scan, as the engine calls it
    c = max(range(len(specs)), key=lambda i: specs[i][2])
    cs, cl, nc = specs[c]
    lanes = slice(lane_off[c], lane_off[c] + nc)
    args = (lane_lo[lanes], lane_hi[lanes], lane_mask[lanes], sa, cs, cl,
            s.max_cardinality, 0, k, s.reverse)
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
    record("scan_core", "scan_core.cu", "asgart_tpu/device_engine.py:249",
           err, cuda_ms(kd), cuda_ms(pd),
           f"{nc} lanes, {got.n_events} events, {got.total_kept} matches",
           9 * nc + 4 * reads + 4 * got.flat.numel(), 8 * reads + 20 * nc)
    return rows, M


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
             kernels=WHOLE, min_sds: int = 1) -> list:
    """One path: the kernel checks, the host engine, then two runs through
    the user entry point; the JSON must hold at least ``min_sds``
    duplications. Returns the path's kernel rows with their main-path
    launch counts."""
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
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mbp", type=float, default=128.0,
                    help="synthetic genome size in Mbp (default 128)")
    args = ap.parse_args(argv)

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
    del g
    print(f"genome: {n} bp synthetic (seed {SEED}) in "
          f"{time.time() - t0:.1f} s", flush=True)

    rc = dict(reverse=True, complement=True)
    rows = []
    for k in (20, 25):  # one-word and two-word sort keys
        rows += run_path(fa, n, device, "whole", RunSettings(probe_size=k,
                                                            **rc))
    rows += run_path(fa, n, device, "shards", RunSettings(probe_size=20,
                                                         **rc),
                     shards=SHARDS, kernels=WINDOW)
    # a quarter of the genome around its middle (its N run), two-word
    # keys; at the default size it holds planted -RC pairs (a quick run's
    # smaller genome may have none there)
    trim = (3 * n // 8, 5 * n // 8)
    rows += run_path(fa, n, device, "trim", RunSettings(probe_size=25,
                                                       trim=trim, **rc),
                     kernels=WINDOW, min_sds=1 if args.mbp >= 100 else 0)
    assert "jax" not in sys.modules
    assert not [m for m in sys.modules
                if m == "asgart_tpu" or m.startswith("asgart_tpu.")]

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
