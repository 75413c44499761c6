"""KJ and KH on one H100, apart from chip_smoke.py's paths.

    python3 scripts/kj_kh_probe.py [--root DIR] [--mbp 128]

``--root`` is the checkout whose ``asgart_tpu_torch`` is measured (default:
this one), so that two versions are compared in one call; the helpers
(``cuda_ms``, ``kernel_ms``, ``kernel_profile``, ``smi_line``) come from
this checkout's chip_smoke.py. Every time is a 20-call mean (CUDA events):
the wrapper's call, and its launches alone behind a busy-wait on the card
(``kernel_ms``; the call's time where the wrapper waits for the card).

KJ ``invert_tables`` on the table engine's text (chip_smoke's ``table``
path: the 128 Mbp synthetic genome, -RC, k = 20, 2 n1 - 1 rows) against
three ``index_put_`` calls, and KC ``invert_fused`` on the same input
with W = 0, an all-true lane mask and no chunk (the table form's
scatter), each checked against KJ; with the CUDA kernels of one call.

KH ``mj_ranges`` on chip_smoke's ``mj_trim`` window (its middle quarter,
k = 20) probed by the whole genome's lanes, against two
``torch.searchsorted`` calls: the masked lanes, the share whose range is
longer than 32 rows; where the measured package has a key directory
(``mj_directory``), KH without one and with one of 2^bits buckets for the
default bits and two smaller, each with its key and directory reads
counted by the kernel (``mj_ranges_reads``) and the directory's build
against its plain version. Without a directory the kernel reads the keys
the parent's search read, less one re-read of the lower bound's key for
each masked lane whose lower bound lies inside the window (added back for
the parent's count). Prints one line per measurement, the card first.
Needs a CUDA GPU.
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


def alone(cs_mod, fn) -> str:
    """``fn``'s launches alone, or the call's time where ``fn`` waits for
    the card: 20-call means."""
    try:
        return f"alone {cs_mod.kernel_ms(fn, REPS):.4f} ms"
    except AssertionError:
        return f"waits: call {cs_mod.cuda_ms(fn, REPS):.4f} ms"


def genome(cs_mod, mbp) -> str:
    import numpy as np

    from asgart_tpu_torch.synthetic import synthetic_genome

    n = int(mbp * 1e6)
    work = os.path.join(HERE, "build", "kj_kh_probe")
    os.makedirs(work, exist_ok=True)
    fa = os.path.join(work, "genome.fa")
    g = synthetic_genome(n, np.random.default_rng(cs_mod.SEED))
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + g.tobytes() + b"\n")
    return fa


def kj_probe(cs_mod, fa, device):
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import probe_span, sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          invert_tables, pack_keys)

    k = 20
    _, _, strand = prepare_data([fa], False, None)
    n1 = len(strand.data)
    n = probe_span(n1, True)
    codes = upload_codes(strand.data, device)
    keys, _ = pack_keys(codes, (), k, True, True, n, 0, doubled=True)
    del codes
    skeys, sa = sort_keys(keys)
    run_lo, run_hi, tied = group_bounds(skeys, sa, n1, flag_n_k=k,
                                        run_end=False)
    del skeys, tied
    torch.cuda.empty_cache()
    # step 1: the planes in position order, KC's with W = 0
    kj = lambda: invert_tables(sa, run_lo, run_hi, 1)  # noqa: E731
    pos_lo, pos_hi, rank = kj()
    sa64 = sa.long()
    lib = [torch.empty(n, dtype=torch.int32, device=device)
           for _ in range(3)]

    def lj():  # three index_put_ calls (and the sign mask)
        lib[0].index_put_((sa64,), run_lo)
        lib[1].index_put_((sa64,), run_hi)
        lib[2].index_put_((sa64,), run_lo & 0x7FFFFFFF)

    lj()
    if any(not torch.equal(a, b) for a, b in zip(lib, (pos_lo, pos_hi,
                                                       rank))):
        raise AssertionError("KJ differs from index_put_")
    mask = torch.ones(n, dtype=torch.bool, device=device)
    kc = lambda: invert_fused(sa, run_lo, run_hi, mask, 0, [0])  # noqa: E731
    _, lane_lo, lane_hi, _ = kc()
    if not (torch.equal(lane_lo, pos_lo) and torch.equal(lane_hi, pos_hi)):
        raise AssertionError("KC with W = 0 differs from KJ")
    del lane_lo, lane_hi
    torch.cuda.empty_cache()
    tag = f"table k={k} n={n} text rows"
    print(f"{tag} KJ profile of one call: {cs_mod.kernel_profile(kj)}",
          flush=True)
    t = [(cs_mod.cuda_ms(f, REPS), alone(cs_mod, f))
         for f in (kj, lj, kc, kc, lj, kj)]
    print(f"{tag} KJ invert_tables wrapper {t[0][0]:.4f} ms ({t[0][1]}) / "
          f"{t[5][0]:.4f} ({t[5][1]}); three index_put_ {t[1][0]:.4f} "
          f"({t[1][1]}) / {t[4][0]:.4f} ({t[4][1]}); KC invert_fused W = 0, "
          f"all-true mask, no chunk {t[2][0]:.4f} ({t[2][1]}) / "
          f"{t[3][0]:.4f} ({t[3][1]}); KC's lane_lo / lane_hi equal KJ's "
          f"pos_lo / pos_hi", flush=True)


def kh_probe(cs_mod, fa, device):
    import torch

    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.kernels import mj_ranges, pack_keys
    from asgart_tpu_torch.kernels import merge_join
    from asgart_tpu_torch.kernels.pack_keys import chunk_tables
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.window_index import window_arrays_from_codes
    from asgart_tpu_torch.codes import upload_codes

    k = 20
    s = RunSettings(probe_size=k, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    n = len(strand.data) - 1
    ws, we = 3 * n // 8, 5 * n // 8
    W = we - ws + 1
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    lane_off = chunk_tables(specs, n1, k, True, True)[0]
    total = lane_off[-1]
    codes = upload_codes(strand.data, device)
    skey, _ = window_arrays_from_codes(codes, k, W, ws)
    (pkey,), mask = pack_keys(codes, specs, k, True, True, 0, total)
    del codes
    torch.cuda.empty_cache()
    n_masked = int(mask.sum())
    tag = (f"mj_trim k={k} W={W} (ws={ws}) {total} lanes ({n_masked} "
           f"masked in, {len(specs)} chunks)")
    lo, hi, totals = mj_ranges(skey, pkey, mask, lane_off)
    runs = (hi - lo).to(torch.int64)
    inside = int((mask & (lo < W)).sum())
    print(f"{tag}: {int((runs > 32).sum())} lanes in runs longer than 32 "
          f"rows ({int((runs > 32).sum()) / max(n_masked, 1):.6f} of the "
          f"masked), longest {int(runs.max())}, raw total "
          f"{int(totals.sum())}; {inside} masked lanes with a lower bound "
          "inside the window", flush=True)
    sk, pk = skey >> 1, pkey >> 1

    def lh():  # the two searchsorted calls and the masked sums
        a = torch.searchsorted(sk, pk, side="left")
        b = torch.searchsorted(sk, pk, side="right")
        return torch.where(mask, b - a, 0).sum()

    kh = lambda: mj_ranges(skey, pkey, mask, lane_off)  # noqa: E731
    t = [(cs_mod.cuda_ms(f, REPS), alone(cs_mod, f)) for f in (kh, lh, lh,
                                                              kh)]
    print(f"{tag} KH without a directory: wrapper {t[0][0]:.4f} ms "
          f"({t[0][1]}) / {t[3][0]:.4f} ({t[3][1]}); two torch.searchsorted "
          f"{t[1][0]:.4f} ({t[1][1]}) / {t[2][0]:.4f} ({t[2][1]})",
          flush=True)
    if not hasattr(merge_join, "mj_directory"):
        return
    from asgart_tpu_torch.kernels.merge_join import (mj_directory,
                                                     mj_directory_bits,
                                                     mj_directory_plain,
                                                     mj_ranges_plain,
                                                     mj_ranges_reads)

    want = mj_ranges_plain(skey, pkey, mask, lane_off)
    reads, _ = mj_ranges_reads(skey, pkey, mask, lane_off)
    print(f"{tag} key reads without a directory {reads} "
          f"({reads / max(n_masked, 1):.3f} a masked lane); the parent's "
          f"search {reads + inside} ({(reads + inside) / max(n_masked, 1):.3f}"
          " a masked lane)", flush=True)
    top = mj_directory_bits(W, k)
    for bits in (top, top - 4, top - 8):
        d = mj_directory(skey, k, bits)
        dp = mj_directory_plain(skey, k, bits)
        if not torch.equal(d.table, dp.table):
            raise AssertionError(f"mj_directory differs from its plain "
                                 f"version at bits={bits}")
        sizes = (d.table[1:] - d.table[:-1]).to(torch.int64)
        got = mj_ranges(skey, pkey, mask, lane_off, d)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"KH with a directory of {bits} bits "
                                 "differs from its plain version")
        reads, dreads = mj_ranges_reads(skey, pkey, mask, lane_off, d)
        kd = lambda: mj_ranges(skey, pkey, mask, lane_off, d)  # noqa: E731
        bd = lambda: mj_directory(skey, k, bits)  # noqa: E731
        bp = lambda: mj_directory_plain(skey, k, bits)  # noqa: E731
        t = [(cs_mod.cuda_ms(f, REPS), alone(cs_mod, f)) for f in (kd, kd)]
        print(f"{tag} KH with a directory of 2^{bits} buckets "
              f"({d.nbytes()} B; buckets: {int((sizes == 0).sum())} empty, "
              f"mean {float(sizes.double().mean()):.1f}, largest "
              f"{int(sizes.max())} rows): wrapper {t[0][0]:.4f} ms "
              f"({t[0][1]}) / {t[1][0]:.4f} ({t[1][1]}); key reads {reads} "
              f"({reads / max(n_masked, 1):.3f} a masked lane), directory "
              f"reads {dreads}; the directory's build "
              f"{cs_mod.cuda_ms(bd, REPS):.4f} ms (it reads its flag "
              "back), plain "
              f"{cs_mod.cuda_ms(bp, 3):.4f} ms", flush=True)
        if bits == top:
            print(f"{tag} KH profile of one call (2^{bits} buckets): "
                  f"{cs_mod.kernel_profile(kd)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose asgart_tpu_torch is measured")
    ap.add_argument("--mbp", type=float, default=128.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kj_kh_probe: CUDA is not available", file=sys.stderr)
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
    fa = genome(cs_mod, args.mbp)
    kj_probe(cs_mod, fa, device)
    torch.cuda.empty_cache()
    kh_probe(cs_mod, fa, device)
    print(cs_mod.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
