"""GPU smoke run of the PyTorch / CUDA port (asgart_tpu_torch) on one card.

    python3 chip_smoke.py            # the full run: 128 Mbp, -RC, k = 20, 25
    python3 chip_smoke.py --mbp 4    # a quick run at a smaller genome

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from asgart_tpu_torch/csrc with nvcc;
3. for each path, -RC at k = 20 (one-word keys) and k = 25 (two-word
   keys) on ``bench.synthetic_genome`` (fixed seed) written as FASTA:
   a. runs each kernel and its plain PyTorch version on the card, on the
      arrays of that path (the fused build of the genome and its largest
      chunk's scan; KE/KF on the first, largest tie round), requires
      equal outputs (tolerance 0: all integers) and times both with CUDA
      events after a warm-up; times the key sort and the whole tie
      resolution with KE/KF against the same rounds on their plain
      versions;
   b. runs the host engine once (the first run also builds the shared
      native chain library, which the timed runs then find built);
   c. drives the path through the user entry point
      ``asgart_tpu_torch.pipeline.search_duplications(engine="cuda")``,
      cold and then warm (a device index cache hit), with every launch
      counter set to 0 just before and read just after; requires the
      JSON bytes of all three runs to be equal and every kernel to have
      been launched;
4. prints a {"kernels": [...]} line (each kernel once per path, with its
   k), the card again, and last {"ok": true, "device": {...}}.

Any failure raises before the last line; without CUDA it exits non-zero
and prints no result. Nothing of JAX is imported.
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
PROBE_SIZES = (20, 25)  # one-word and two-word sort keys


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


def json_text(result) -> str:
    from asgart_tpu.exporters import JSONExporter

    buf = io.StringIO()
    JSONExporter().save(result, buf)
    return buf.getvalue()


def kernel_checks(fa: str, settings, device) -> tuple[list, int]:
    """Each kernel against its plain version at the shapes of one path.
    Returns (kernel rows, fused rows M)."""
    import torch

    from asgart_tpu.fasta import prepare_data
    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fused_index import fused_layout, sort_keys
    from asgart_tpu_torch.host_helpers import _strand_fingerprint
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          pack_keys, scan_core, tie_keys,
                                          tie_refine)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain
    from asgart_tpu_torch.kernels.ties import (tie_keys_plain,
                                               tie_refine_plain)

    s = settings
    k = s.probe_size
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    W, total, lane_off = fused_layout(n1, specs)
    M = W + total
    rows = []

    def record(name, src, replaces, err, ms, plain_ms, shape):
        print(f"k={k} kernel {name}: max_abs_err={err} kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms at {shape}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at k = {k} (max_abs_err {err})")
        rows.append({"name": name, "k": k, "route": "cuda",
                     "source": f"asgart_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})

    t0 = time.time()
    _strand_fingerprint(strand.data)
    t_fp = time.time() - t0
    t0 = time.time()
    codes = upload_codes(strand.data, device)
    torch.cuda.synchronize()
    print(f"k={k} host side of a build: strand fingerprint {t_fp:.3f} s, "
          f"codes LUT + pinned upload {time.time() - t0:.3f} s (host clock)")
    tabs = chunk_tables(specs, n1, k, s.reverse, s.complement)
    ka = lambda: pack_keys(codes, specs, k, s.reverse, s.complement, W,  # noqa: E731
                           total)
    kp = lambda: pack_keys_plain(codes, *tabs, k, s.reverse,  # noqa: E731
                                 s.complement, W, total)
    keys, lane_mask = ka()
    want_keys, want_mask = kp()
    err = max_abs_err((*keys, lane_mask), (*want_keys, want_mask))
    del want_keys, want_mask
    record("pack_keys", "pack_keys.cu",
           "asgart_tpu/device_engine.py:904" if len(keys) == 1
           else "asgart_tpu/device_engine.py:761",
           err, cuda_ms(ka), cuda_ms(kp), f"M={M}, {len(keys)} key words")
    del codes

    ms = cuda_ms(lambda: sort_keys([w.clone() for w in keys]))
    words = len(keys)
    skeys, sa = sort_keys(keys)
    print(f"k={k} stable sort of {M} rows by {words} key word(s) "
          f"(fused_index.sort_keys, torch.sort): {ms:.3f} ms (CUDA events, "
          "incl. a copy of the keys)", flush=True)

    kb = lambda: group_bounds(skeys, sa, W)  # noqa: E731
    pb = lambda: group_bounds_plain(skeys, sa, W)  # noqa: E731
    run_lo, run_hi, tied = kb()
    err = max_abs_err((run_lo, run_hi, tied), pb())
    record("group_bounds", "group_bounds.cu",
           "asgart_tpu/device_index.py:352", err, cuda_ms(kb), cuda_ms(pb),
           f"M={M}, {words} key words")
    del skeys

    kc = lambda: invert_fused(sa, run_lo, run_hi, lane_mask, W,  # noqa: E731
                              lane_off)
    pc = lambda: invert_fused_plain(sa, run_lo, run_hi,  # noqa: E731
                                    lane_mask, W, lane_off)
    rank, lane_lo, lane_hi, totals = kc()
    err = max_abs_err((rank, lane_lo, lane_hi, totals), pc())
    record("invert_fused", "invert.cu", "asgart_tpu/device_index.py:1519",
           err, cuda_ms(kc), cuda_ms(pc), f"M={M}")
    del run_lo, run_hi

    # KE / KF on the first tie round (the largest tied set); KF writes sa
    # and rank in place, so each side gets its own copies (KF reads
    # neither, so repeated calls write the same values)
    slots = torch.nonzero(tied).flatten()
    n_tied = slots.numel()
    if n_tied == 0:
        raise AssertionError(f"no tied rows at k = {k}: KE/KF unchecked")
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
           cuda_ms(ke), cuda_ms(pe), f"{n_tied} tied entries")
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
           cuda_ms(kf), cuda_ms(pf), f"{n_tied} tied entries")
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
                             f"plain rounds at k = {k}")
    sa = finals[False]
    del finals, rank, tied
    print(f"k={k} tie resolution of {n_tied} tied rows: KE/KF "
          f"{' / '.join(f'{t:.4f}' for t in times[False])} s, plain rounds "
          f"{' / '.join(f'{t:.4f}' for t in times[True])} s (host clock + "
          "sync)", flush=True)

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
    record("scan_core", "scan_core.cu", "asgart_tpu/device_engine.py:249",
           err, cuda_ms(kd), cuda_ms(pd),
           f"{nc} lanes, {got.n_events} events, {got.total_kept} matches")
    return rows, M


def run_path(fa: str, k: int, n: int, device) -> list:
    """One path (-RC at probe size k): the kernel checks, the host
    engine, then the cold and warm runs through the user entry point.
    Returns the path's kernel rows with their main-path launch counts."""
    import torch

    from asgart_tpu.structs import RunSettings
    from asgart_tpu_torch import kernels
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications

    settings = RunSettings(reverse=True, complement=True, probe_size=k)
    rows, fused_rows = kernel_checks(fa, settings, device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t0 = time.time()
    host = json_text(search_duplications([fa], settings, engine="host"))
    t_host = time.time() - t0

    # the main path, through the user entry point, from an empty cache
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    runs = {}
    for tag in ("cold", "warm"):
        prof: dict = {}
        t0 = time.time()
        res = search_duplications([fa], settings, engine="cuda",
                                  device=device, profile=prof)
        torch.cuda.synchronize()
        runs[tag] = (time.time() - t0, json_text(res), prof)
        if tag == "cold":
            peak = torch.cuda.max_memory_allocated(device)
    counts = kernels.launch_counts()

    for tag, (t, text, prof) in runs.items():
        print(f"k={k} cuda {tag}: {t:.3f} s wall, {n / 1e6 / t:.2f} Mbp/s, "
              f"phases {json.dumps(prof)}")
    print(f"k={k} host engine: {t_host:.3f} s wall")
    n_sds = sum(len(f) for f in json.loads(host)["families"])
    print(f"k={k} JSON {len(host)} bytes, {n_sds} SDs; peak device memory "
          f"of the cold run {peak} B = {peak / fused_rows:.2f} B per fused "
          f"row ({fused_rows} rows)")
    print(f"k={k} launches on the main path: {json.dumps(counts)}",
          flush=True)
    for tag, (_, text, _) in runs.items():
        if text != host:
            raise AssertionError(f"k={k} cuda {tag} JSON differs from the "
                                 f"host engine's ({len(text)} vs "
                                 f"{len(host)} bytes)")
    if n_sds < 1:
        raise AssertionError(f"no duplication found at k = {k}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"k = {k} main path")
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
    from bench import synthetic_genome

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

    rows = []
    for k in PROBE_SIZES:
        rows += run_path(fa, k, n, device)
    assert "jax" not in sys.modules

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
