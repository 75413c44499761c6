"""KD and KC on one H100, apart from chip_smoke.py's paths.

    python3 scripts/kd_kc_probe.py [--root DIR] [--mbp 128] [--repeats-mbp 64]

``--root`` is the checkout whose ``asgart_tpu_torch`` is measured (default:
this one), so that two versions are compared in one call; the helpers
(``kernel_profile``, ``window_histogram``, ``cuda_ms``, ``kernel_ms``,
``repeat_genome``) come from this checkout's chip_smoke.py.

KD ``scan_core`` on the largest chunk of the whole genome at k = 20 (the
fused build of chip_smoke's 128 Mbp synthetic genome, -RC) and on the
table engine's largest chunk of chip_smoke's repeat-dense genome
(table_repeats, 64 Mbp, -RC, k = 20): the CUDA kernels of one call with
their device times (``torch.profiler``), the call's time (CUDA events, the
wrapper and its launches alone), and the masked windows' lengths by powers
of two. KC ``invert_fused`` with no lanes on a random permutation of M
rows (KC alone and ``index_put_`` alone) at M = 2, 4, 8 M (an output that
fits the 50 MB L2) and 32 M (128 MB, mj_trim's window), with the CUDA
kernels of one 32 M-row call, the identity permutation (a coalesced
scatter) and a coalesced copy of the same bytes.
Prints one line per measurement, the card first. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def smoke():
    """This checkout's chip_smoke.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kd_probe(cs_mod, tag, lane_lo, lane_hi, lane_mask, sa, consts, s):
    import torch

    from asgart_tpu_torch.kernels import scan_core
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain

    args = (lane_lo, lane_hi, lane_mask, sa, *consts, s.max_cardinality, 0,
            s.probe_size, s.reverse)
    got, want = scan_core(*args), scan_core_plain(*args)
    if not torch.equal(got.flat, want.flat):
        raise AssertionError(f"{tag}: scan_core differs from its plain "
                             "version")
    print(f"{tag} KD: {lane_lo.numel()} lanes, {got.n_events} events, "
          f"{got.total_kept} matches", flush=True)
    print(f"{tag} KD window lengths: "
          f"{cs_mod.window_histogram(lane_lo, lane_hi, lane_mask)}",
          flush=True)
    print(f"{tag} KD profile of one call: "
          f"{cs_mod.kernel_profile(lambda: scan_core(*args))}", flush=True)
    kd = cs_mod.cuda_ms(lambda: scan_core(*args), REPS)
    plain = cs_mod.cuda_ms(lambda: scan_core_plain(*args), REPS)
    print(f"{tag} KD wrapper {kd:.4f} ms, plain {plain:.4f} ms (CUDA "
          "events, 20-call means)", flush=True)


def whole_k20(cs_mod, mbp, device):
    import numpy as np

    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import FusedIndex
    from asgart_tpu_torch.kernels.scan_core import fused_bases
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.synthetic import synthetic_genome

    n = int(mbp * 1e6)
    work = os.path.join(HERE, "build", "kd_kc_probe")
    os.makedirs(work, exist_ok=True)
    fa = os.path.join(work, "genome.fa")
    g = synthetic_genome(n, np.random.default_rng(cs_mod.SEED))
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + g.tobytes() + b"\n")
    del g
    s = RunSettings(probe_size=20, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    idx = FusedIndex.build(strand.data, 20, specs, True, True, device)
    c = max(range(len(specs)), key=lambda i: specs[i][2])
    cs, cl, nc = specs[c]
    off = idx.offs[(cs, cl)][0]
    lanes = slice(off, off + nc)
    kd_probe(cs_mod, f"whole k=20 {mbp:g} Mbp chunk ({cs}, {cl})",
             idx.lane_lo[lanes], idx.lane_hi[lanes], idx.lane_mask[lanes],
             idx.sa, fused_bases(cs, cl), s)


def table_repeats(cs_mod, mbp, device):
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.kernels import table_ranges
    from asgart_tpu_torch.kernels.scan_core import fused_bases
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.table_index import DeviceIndex

    n = int(mbp * 1e6)
    work = os.path.join(HERE, "build", "kd_kc_probe")
    os.makedirs(work, exist_ok=True)
    fa = os.path.join(work, "repeats.fa")
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + cs_mod.repeat_genome(n).tobytes() + b"\n")
    s = RunSettings(probe_size=20, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    idx = DeviceIndex.build(strand.data, 20, True, True, device)
    lane_lo, lane_hi, lane_mask, _, lane_off = table_ranges(
        idx.pos_lo, idx.pos_hi, specs, n1, 20, True, True)
    c = max(range(len(specs)), key=lambda i: specs[i][2])
    cs, cl, nc = specs[c]
    lanes = slice(lane_off[c], lane_off[c] + nc)
    kd_probe(cs_mod, f"table_repeats {mbp:g} Mbp chunk ({cs}, {cl})",
             lane_lo[lanes], lane_hi[lanes], lane_mask[lanes], idx.sa,
             fused_bases(cs, cl), s)


def alone(cs_mod, fn) -> str:
    """``fn``'s launches alone (``kernel_ms``), or, where ``fn`` waits for
    the card (the parent's KC uploads its chunk offsets from pageable
    memory), the call's time (``cuda_ms``): 20-call means."""
    try:
        return f"alone {cs_mod.kernel_ms(fn, REPS):.4f} ms"
    except AssertionError:
        return f"wrapper {cs_mod.cuda_ms(fn, REPS):.4f} ms"


def kc_probe(cs_mod, device):
    import torch

    from asgart_tpu_torch.kernels import invert_fused

    none = torch.zeros(0, dtype=torch.bool, device=device)
    g = torch.Generator(device=device).manual_seed(cs_mod.SEED)
    for rows in (2 << 20, 4 << 20, 8 << 20, 32 << 20):
        perm = torch.randperm(rows, device=device, generator=g,
                              dtype=torch.int64)
        perm32 = perm.to(torch.int32)
        vals = torch.randint(0, 1 << 30, (rows,), device=device,
                             generator=g, dtype=torch.int32)
        out = torch.empty(rows, dtype=torch.int32, device=device)
        kc = lambda: invert_fused(perm32, vals, vals, none, rows,  # noqa: E731
                                  [0])
        lib = lambda: out.index_put_((perm,), vals)  # noqa: E731
        if not torch.equal(kc()[0], lib()):
            raise AssertionError("KC differs from index_put_")
        t = [alone(cs_mod, f) for f in (kc, lib, kc, lib)]
        line = (f"KC scatter of a random permutation, {rows} rows "
                f"({4 * rows} B out): KC {t[0]} / {t[2]}, index_put_ "
                f"{t[1]} / {t[3]}")
        if rows == 32 << 20:
            print(f"KC profile of one call, {rows} rows: "
                  f"{cs_mod.kernel_profile(kc)}", flush=True)
            ident = torch.arange(rows, device=device, dtype=torch.int64)
            ident32 = ident.to(torch.int32)
            ki = lambda: invert_fused(ident32, vals, vals, none,  # noqa: E731
                                      rows, [0])
            li = lambda: out.index_put_((ident,), vals)  # noqa: E731
            cp = lambda: out.copy_(vals)  # noqa: E731
            line += (f"; identity permutation: KC {alone(cs_mod, ki)}, "
                     f"index_put_ {alone(cs_mod, li)}; coalesced copy of "
                     f"the {4 * rows} B {alone(cs_mod, cp)}")
            del ident, ident32
        print(line, flush=True)
        del perm, perm32, vals, out
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose asgart_tpu_torch is measured")
    ap.add_argument("--mbp", type=float, default=128.0)
    ap.add_argument("--repeats-mbp", type=float, default=64.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kd_kc_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    cs_mod = smoke()
    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.kernels import _build

    print(cs_mod.smi_line())
    print(f"measured package: {os.path.abspath(args.root)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    _build.lib()
    print(f"kernel library built and loaded in {time.time() - t0:.1f} s",
          flush=True)
    device = cuda_device()
    kc_probe(cs_mod, device)
    whole_k20(cs_mod, args.mbp, device)
    torch.cuda.empty_cache()
    table_repeats(cs_mod, args.repeats_mbp, device)
    print(cs_mod.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
