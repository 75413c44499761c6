"""KA and KL on one H100, apart from chip_smoke.py's paths.

    python3 scripts/ka_kl_probe.py [--root DIR] [--mbp 128] [--repeats-mbp 64]

``--root`` is the checkout whose ``asgart_tpu_torch`` is measured (default:
this one), so that two versions are compared in one call; the helpers
(``cuda_ms``, ``kernel_ms``, ``kernel_profile``, ``bound``, ``smi_line``,
``repeat_genome``) come from this checkout's chip_smoke.py. Every time is
a 20-call mean (CUDA events): the wrapper's call, and its launches alone
behind a busy-wait on the card (``kernel_ms``; "waits" where the wrapper
waits for the card).

KA ``pack_keys`` at chip_smoke's shapes (the ``--mbp`` synthetic genome,
seed 1234, -RC), each held to ``pack_keys_plain`` and timed beside a
store-only floor (one ``fill_`` of each output, the same bytes written
coalesced): the whole genome's fused build at k = 20, split into its
direct rows alone (total = 0) and its probe rows alone (W = 0), and at
k = 25 (two words); the table engine's doubled text (2 n1 - 1 rows) at
k = 20 and k = 25; the middle quarter's window keys (mj_trim) and probe
keys (W = 0: mj_trim, big_trim and the mesh cell take this call); the
fused window builds of the shards path's window 2 (k = 20) and the trim
path's middle quarter (k = 25); and probe keys past 2^31 (big_whole's
case): four 100 Mbp chunks from 1.8e9 in 2.2e9 random codes made on the
card from the seed.

KL ``full_round_refine`` on the first full round of the table build of
the ``--repeats-mbp`` repeat-dense genome (chip_smoke's table_repeats,
k = 20): KL whole; KL with the identity order (where KL is
one kernel, its in-order part: every read and store in order, the rank
store too; where it is an in-order pass and a scatter, the profile of
one call splits them); how
far ``order[r]`` lies from r; KC ``invert_fused`` with no lanes (M = W =
n) on the (new_sa, run start) pair; and ``index_put_`` of ``rank[new_sa]
= s``; each rank checked against KL's; the CUDA kernels of one KL call.
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
BIG_N1 = 2_200_000_001  # big_whole's case: codes past 2^31
BIG_FIRST, BIG_CHUNK, BIG_CHUNKS = 1_800_000_000, 100_000_000, 4


def smoke():
    """This checkout's chip_smoke.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_fa(path, g) -> str:
    with open(path, "wb") as fh:
        fh.write(b">chr1\n" + g.tobytes() + b"\n")
    return path


def alone(cs, fn) -> str:
    """``fn``'s launches alone, or "waits" where ``fn`` waits for the card
    (a pageable copy of host data): 20-call means."""
    try:
        return f"alone {cs.kernel_ms(fn, REPS):.4f}"
    except AssertionError:
        return "waits for the card"


def ka_case(cs, tag, call, plain, codes_bytes, k):
    """One KA shape: the kernel against its plain version, its time, its
    launches alone and the store-only floor of its outputs."""
    import torch

    keys, mask = call()
    want, want_mask = plain()
    err = cs.max_abs_err((*keys, mask), (*want, want_mask))
    del want, want_mask
    if err:
        raise AssertionError(f"{tag}: KA differs from pack_keys_plain "
                             f"(max_abs_err {err})")
    outs = [*keys, mask]
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    rows = keys[0].numel()

    def floor():
        for t in outs:
            t.fill_(0)

    t = [cs.cuda_ms(f, REPS) for f in (call, floor, floor, call)]
    a = alone(cs, call)
    b_ms, b_by = cs.bound(codes_bytes + out_bytes, rows * (4 * k + 8))
    print(f"KA {tag}: {rows} rows, {len(keys)} word(s), max_abs_err 0; "
          f"wrapper {t[0]:.4f} / {t[3]:.4f} ms ({a}); store-only "
          f"floor {t[1]:.4f} / {t[2]:.4f} ms ({out_bytes} B); bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    del keys, mask, outs
    torch.cuda.empty_cache()


def ka_probe(cs, fa, device):
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import fused_layout
    from asgart_tpu_torch.kernels import pack_keys
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.pipeline import plan_windows
    from asgart_tpu_torch.structs import RunSettings

    rc = (True, True)
    s20 = RunSettings(probe_size=20, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s20.skip_masked, None)
    n1 = len(strand.data)
    n = n1 - 1
    codes = upload_codes(strand.data, device)
    first = True
    for k in (20, 25):
        specs = chunk_specs(chunks, RunSettings(probe_size=k, reverse=True,
                                                complement=True))
        tabs = chunk_tables(specs, n1, k, *rc)
        W, total, _ = fused_layout(n1, specs)
        cases = [("fused whole", specs, W, total, 0)]
        if k == 20:
            cases += [("fused whole, direct rows alone (total = 0)", (), W,
                       0, 0),
                      ("fused whole, probe rows alone (W = 0)", specs, 0,
                       total, 0)]
        for name, sp, w, tot, ws in cases:
            tb = tabs if sp else ([0], [], [])
            ka_case(cs, f"{name} k={k} (W={w}, total={tot})",
                    lambda: pack_keys(codes, sp, k, *rc, w, tot, ws),
                    lambda: pack_keys_plain(codes, *tb, k, *rc, w, tot, ws),
                    n1, k)
        nd = 2 * n1 - 1
        ka_case(cs, f"table doubled k={k} (n={nd})",
                lambda: pack_keys(codes, (), k, *rc, nd, 0, doubled=True),
                lambda: pack_keys_plain(codes, [0], [], [], k, *rc, nd, 0, 0,
                                        True), n1, k)
        if first:
            # mj_trim's two sides (and big_trim's, the mesh cell's probes)
            ws, we = 3 * n // 8, 5 * n // 8
            Wm = we - ws + 1
            total = tabs[0][-1]
            ka_case(cs, f"mj_trim window keys k={k} (W={Wm}, ws={ws})",
                    lambda: pack_keys(codes, (), k, *rc, Wm, 0, ws),
                    lambda: pack_keys_plain(codes, [0], [], [], k, *rc, Wm,
                                            0, ws), Wm, k)
            ka_case(cs, f"mj_trim probe keys k={k} ({total} lanes)",
                    lambda: pack_keys(codes, specs, k, *rc, 0, total),
                    lambda: pack_keys_plain(codes, *tabs, k, *rc, 0, total),
                    n1, k)
            ws, we = plan_windows(n, 4)[2]
            Wf, tot, _ = fused_layout(we - ws + 1, specs)
            ka_case(cs, f"shards window 2 fused k={k} (W={Wf}, ws={ws}, "
                    f"total={tot})",
                    lambda: pack_keys(codes, specs, k, *rc, Wf, tot, ws),
                    lambda: pack_keys_plain(codes, *tabs, k, *rc, Wf, tot,
                                            ws), Wf + n1, k)
            first = False
        else:
            ws, we = 3 * n // 8, 5 * n // 8
            Wf, tot, _ = fused_layout(we - ws + 1, specs)
            ka_case(cs, f"trim window fused k={k} (W={Wf}, ws={ws}, "
                    f"total={tot})",
                    lambda: pack_keys(codes, specs, k, *rc, Wf, tot, ws),
                    lambda: pack_keys_plain(codes, *tabs, k, *rc, Wf, tot,
                                            ws), Wf + n1, k)
    del codes
    torch.cuda.empty_cache()
    print("KA profile of one call (fused whole k=20): "
          f"{ka_profile(cs, fa, device)}", flush=True)

    # probe keys past 2^31: random ACGT codes made on the card
    k = 20
    step = k // 2
    gen = torch.Generator(device=device)
    gen.manual_seed(cs.SEED)
    big = torch.tensor([1, 2, 3, 5], dtype=torch.uint8, device=device)[
        torch.randint(0, 4, (BIG_N1,), generator=gen, device=device,
                      dtype=torch.uint8).long()]
    big[-1] = 0  # the strand's '$'
    specs = []
    for c in range(BIG_CHUNKS):
        cl = BIG_CHUNK
        specs.append((BIG_FIRST + c * cl, cl, (cl - k - step + step - 1)
                      // step))
    specs = tuple(specs)
    tabs = chunk_tables(specs, BIG_N1, k, *rc)
    total = tabs[0][-1]
    ka_case(cs, f"probe keys past 2^31 k={k} ({total} lanes from "
            f"{BIG_FIRST} of {BIG_N1} codes)",
            lambda: pack_keys(big, specs, k, *rc, 0, total),
            lambda: pack_keys_plain(big, *tabs, k, *rc, 0, total),
            BIG_CHUNKS * BIG_CHUNK, k)
    del big
    torch.cuda.empty_cache()


def ka_profile(cs, fa, device) -> str:
    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import fused_layout
    from asgart_tpu_torch.kernels import pack_keys
    from asgart_tpu_torch.structs import RunSettings

    s = RunSettings(probe_size=20, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    W, total, _ = fused_layout(n1, specs)
    codes = upload_codes(strand.data, device)
    return cs.kernel_profile(
        lambda: pack_keys(codes, specs, 20, True, True, W, total))


def kl_probe(cs, fa, device):
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import probe_span, sort_keys
    from asgart_tpu_torch.kernels import (full_round_keys, full_round_refine,
                                          group_bounds, invert_fused,
                                          invert_tables, pack_keys)
    from asgart_tpu_torch.kernels.ties import full_round_refine_plain

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
    del skeys
    _, _, rank = invert_tables(sa, run_lo, run_hi, k // 2)
    del run_lo, run_hi
    first = int(tied.sum())
    del tied
    key = full_round_keys(rank, k, n1)
    skey, order = torch.sort(key, stable=True)
    del key
    torch.cuda.empty_cache()
    tag = f"table_repeats first full round k={k} n={n} ({first} tied)"
    rank_k, rank_p = rank.clone(), rank.clone()
    kl = lambda: full_round_refine(skey, order, rank_k, n1)  # noqa: E731
    new_sa, tied_k = kl()
    want_sa, want_tied = full_round_refine_plain(skey, order, rank_p, n1)
    if not (torch.equal(new_sa, want_sa) and torch.equal(tied_k, want_tied)
            and torch.equal(rank_k, rank_p)):
        raise AssertionError(f"{tag}: KL differs from its plain version")
    del want_sa, want_tied, rank_p
    # the run start of every sorted row (the plain version's cummax)
    new_run = torch.ones(n, dtype=torch.bool, device=device)
    new_run[1:] = skey[1:] != skey[:-1]
    s = torch.cummax(torch.where(
        new_run, torch.arange(n, device=device), 0), 0).values.to(
        torch.int32)
    runs = int(new_run.sum())
    del new_run
    d = (order - torch.arange(n, device=device)).abs()
    print(f"{tag}: {runs} runs; |order[r] - r| mean {float(d.double().mean()):.1f}, "
          f"max {int(d.max())}, within 2^13 {float((d < 8192).double().mean()):.6f}, "
          f"within 2^21 {float((d < (1 << 21)).double().mean()):.6f}",
          flush=True)
    del d
    ident64 = torch.arange(n, dtype=torch.int64, device=device)
    rank_i = torch.empty_like(rank)
    inorder = lambda: full_round_refine(skey, ident64, rank_i,  # noqa: E731
                                        n1)
    empty_mask = torch.zeros(0, dtype=torch.bool, device=device)
    kc = lambda: invert_fused(new_sa, s, s, empty_mask, n, [0])  # noqa: E731
    rank_c = kc()[0]
    if not torch.equal(rank_c, rank_k):
        raise AssertionError(f"{tag}: KC (M = W = n) differs from KL's rank")
    rank_l = torch.empty_like(rank)
    sa64 = new_sa.long()
    lib = lambda: rank_l.index_put_((sa64,), s)  # noqa: E731
    lib()
    if not torch.equal(rank_l, rank_k):
        raise AssertionError(f"{tag}: index_put_ differs from KL's rank")
    del rank_c
    torch.cuda.empty_cache()
    print(f"{tag} KL profile of one call: {cs.kernel_profile(kl)}",
          flush=True)
    t = {}
    for name, f in (("kl", kl), ("inorder", inorder), ("kc", kc),
                    ("lib", lib), ("lib2", lib), ("kc2", kc),
                    ("inorder2", inorder), ("kl2", kl)):
        t[name] = (cs.cuda_ms(f, REPS), alone(cs, f))
    b_ms, b_by = cs.bound(29 * n, 20 * n)

    def pair(a):
        return (f"{t[a][0]:.4f} ({t[a][1]}) / {t[a + '2'][0]:.4f} "
                f"({t[a + '2'][1]})")

    print(f"{tag}: KL full_round_refine {pair('kl')} ms; KL with the "
          f"identity order (the in-order part) "
          f"{pair('inorder')}; KC invert_fused M = W = n on (new_sa, run "
          f"start) {pair('kc')}; index_put_ rank[new_sa] = s {pair('lib')}; "
          f"KL's bound {b_ms:.4f} ms ({b_by})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose asgart_tpu_torch is measured")
    ap.add_argument("--mbp", type=float, default=128.0)
    ap.add_argument("--repeats-mbp", type=float, default=64.0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ka_kl_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    cs = smoke()
    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.synthetic import synthetic_genome

    print(cs.smi_line())
    print(f"measured package: {os.path.abspath(args.root)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    _build.lib()
    print(f"kernel library built and loaded in {time.time() - t0:.1f} s",
          flush=True)
    device = cuda_device()
    work = os.path.join(HERE, "build", "ka_kl_probe")
    os.makedirs(work, exist_ok=True)
    g = synthetic_genome(int(args.mbp * 1e6), np.random.default_rng(cs.SEED))
    fa = write_fa(os.path.join(work, "genome.fa"), g)
    del g
    ka_probe(cs, fa, device)
    torch.cuda.empty_cache()
    fr = write_fa(os.path.join(work, "repeats.fa"),
                  cs.repeat_genome(int(args.repeats_mbp * 1e6)))
    kl_probe(cs, fr, device)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
