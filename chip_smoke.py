"""GPU smoke run of the PyTorch / CUDA port (asgart_tpu_torch) on one card.

    python3 chip_smoke.py            # the full run: 128 Mbp, -RC, k = 20
    python3 chip_smoke.py --mbp 4    # a quick run at a smaller genome

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the four CUDA kernels from asgart_tpu_torch/csrc with nvcc;
3. runs each kernel and its plain PyTorch version on the card, on the
   arrays of the main path (the fused build of the genome below and its
   largest chunk's scan), requires equal outputs (tolerance 0: all
   integers) and times both with CUDA events after a warm-up;
4. drives the main path through the user entry point
   ``asgart_tpu_torch.pipeline.search_duplications(engine="cuda")`` on
   ``bench.synthetic_genome`` (fixed seed) written as FASTA, cold and then
   warm (a device index cache hit), with every launch counter set to 0
   just before and read just after; runs the host engine once (first,
   so the timed runs find the native chain library built); requires
   the JSON bytes of all three to be equal and every kernel to have been
   launched;
5. prints a {"kernels": [...]} line, the card again, and last
   {"ok": true, "device": {...}}.

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


def kernel_checks(fa: str, settings, device) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from asgart_tpu.fasta import prepare_data
    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fused_index import fused_layout
    from asgart_tpu_torch.host_helpers import _strand_fingerprint
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          pack_keys, scan_core)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain
    from asgart_tpu_torch.ties import resolve_ties

    s = settings
    k = s.probe_size
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    W, total, lane_off = fused_layout(n1, specs)
    rows = []

    def record(name, src, replaces, err, ms, plain_ms, shape):
        print(f"kernel {name}: max_abs_err={err} kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms at {shape}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max_abs_err {err})")
        rows.append({"name": name, "route": "cuda",
                     "source": f"asgart_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})

    t0 = time.time()
    _strand_fingerprint(strand.data)
    t_fp = time.time() - t0
    t0 = time.time()
    codes = upload_codes(strand.data, device)
    torch.cuda.synchronize()
    print(f"host side of a build: strand fingerprint {t_fp:.3f} s, codes "
          f"LUT + pinned upload {time.time() - t0:.3f} s (host clock)")
    tabs = chunk_tables(specs, n1, k, s.reverse, s.complement)
    ka = lambda: pack_keys(codes, specs, k, s.reverse, s.complement, W,  # noqa: E731
                           total)
    kp = lambda: pack_keys_plain(codes, *tabs, k, s.reverse,  # noqa: E731
                                 s.complement, W, total)
    key, lane_mask = ka()
    err = max_abs_err((key, lane_mask), kp())
    record("pack_keys", "pack_keys.cu", "asgart_tpu/device_engine.py:904",
           err, cuda_ms(ka), cuda_ms(kp), f"M={W + total}")
    del codes

    t0 = time.time()
    skey, order = torch.sort(key, stable=True)
    del key
    sa = order.to(torch.int32)
    del order
    torch.cuda.synchronize()
    print(f"stable sort of {W + total} int64 keys: "
          f"{time.time() - t0:.3f} s (host clock, incl. first call)")

    kb = lambda: group_bounds(skey, sa, W)  # noqa: E731
    pb = lambda: group_bounds_plain(skey, sa, W)  # noqa: E731
    run_lo, run_hi, tied = kb()
    err = max_abs_err((run_lo, run_hi, tied), pb())
    record("group_bounds", "group_bounds.cu", "asgart_tpu/device_index.py:352",
           err, cuda_ms(kb), cuda_ms(pb), f"M={W + total}")
    del skey

    kc = lambda: invert_fused(sa, run_lo, run_hi, lane_mask, W,  # noqa: E731
                              lane_off)
    pc = lambda: invert_fused_plain(sa, run_lo, run_hi,  # noqa: E731
                                    lane_mask, W, lane_off)
    rank, lane_lo, lane_hi, totals = kc()
    err = max_abs_err((rank, lane_lo, lane_hi, totals), pc())
    record("invert_fused", "invert.cu", "asgart_tpu/device_index.py:1519",
           err, cuda_ms(kc), cuda_ms(pc), f"M={W + total}")
    del run_lo, run_hi

    t0 = time.time()
    sa = resolve_ties(sa, rank, tied, W + total, k)
    torch.cuda.synchronize()
    print(f"tie resolution ({int(tied.sum())} tied rows): "
          f"{time.time() - t0:.3f} s (host clock)")
    del rank, tied

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
    return rows, W + total


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

    from asgart_tpu.structs import RunSettings
    from asgart_tpu_torch import kernels
    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.pipeline import search_duplications
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
    settings = RunSettings(reverse=True, complement=True)

    rows, fused_rows = kernel_checks(fa, settings, device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the host engine first: its run also builds the shared native chain
    # library (g++), which the timed cuda runs below then find built
    t0 = time.time()
    host = json_text(search_duplications([fa], settings, engine="host"))
    t_host = time.time() - t0

    # the main path, through the user entry point
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
        print(f"cuda {tag}: {t:.3f} s wall, {n / 1e6 / t:.2f} Mbp/s, "
              f"phases {json.dumps(prof)}")
    print(f"host engine: {t_host:.3f} s wall")
    n_sds = sum(len(f) for f in json.loads(host)["families"])
    print(f"JSON {len(host)} bytes, {n_sds} SDs; peak device memory of "
          f"the cold run {peak} B = {peak / fused_rows:.2f} B per fused row "
          f"({fused_rows} rows)")
    print(f"launches on the main path: {json.dumps(counts)}")
    for tag, (_, text, _) in runs.items():
        if text != host:
            raise AssertionError(f"cuda {tag} JSON differs from the host "
                                 f"engine's ({len(text)} vs {len(host)} "
                                 "bytes)")
    if n_sds < 1:
        raise AssertionError("no duplication found in the synthetic genome")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    for row in rows:
        row["launches"] = counts[row["name"]]
    assert "jax" not in sys.modules

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
