"""KK, KL and KH's key directory on one H100, apart from chip_smoke.py's
paths.

    python3 scripts/kk_dir_probe.py [--root DIR] [--mbp 128] [--repeats-mbp 64]

``--root`` is the checkout whose ``asgart_tpu_torch`` is measured (default:
this one), so that two versions are compared in one call; the helpers
(``cuda_ms``, ``kernel_ms``, ``kernel_profile``, ``bound``, ``smi_line``,
``repeat_genome``) come from this checkout's chip_smoke.py. Every time is
a 20-call mean (CUDA events): the wrapper's call, and its launches alone
behind a busy-wait on the card (``kernel_ms``; "waits" where the wrapper
waits for the card). Both signatures of KK and KL are driven: the one
that reads the order ``sa`` (gathering ``rank[sa[i]]``) and the one that
builds the keys in position order.

The first full round of the table build of the ``--repeats-mbp``
repeat-dense genome (chip_smoke's table_repeats, k = 20, 128 M rows): KK
``full_round_keys`` against its plain version, beside a store-only
``fill_`` floor of its keys (1 GB) and its bound; the stable sort of the
keys; KL ``full_round_refine`` against its plain version, and its
in-order pass alone (the library's entry point on buffers made once);
the whole round (KK, the sort, KL, the rank restored by a copy timed
apart), the CUDA kernels of one round, and checksums of its outputs
(equal between two versions that compute the same round); then
``ties.full_rounds`` from the build's first tied state (its two rounds,
host clock around a synchronize, 3 runs).

KH's key directory ``mj_directory`` on the ``--mbp`` synthetic genome
(seed 1234; its sorted window keys at k = 20): mj_trim's window (the
middle quarter, 32 M rows), the shards path's window 2 and a rank's
shard of mj_trim's keys (rows [Wl, 2 Wl) of 4, whose keys cover part of
the key space), each against ``mj_directory_plain``: the entry point's
launch alone, the wrapper, and the wrapper with its flag read back (the
parent's wrapper reads it itself), beside its bound. Prints one line per
measurement, the card first. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
RUNS = 3  # ties.full_rounds runs (host clock)


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
    """``fn``'s launches alone, or "waits" where ``fn`` waits for the card:
    20-call means."""
    try:
        return f"alone {cs.kernel_ms(fn, REPS):.4f}"
    except AssertionError:
        return "waits for the card"


def timed(cs, fn) -> str:
    return f"{cs.cuda_ms(fn, REPS):.4f} ({alone(cs, fn)})"


def checksum(t) -> int:
    """A position-weighted sum of an integer tensor (int64 arithmetic)."""
    import torch

    w = torch.arange(t.numel(), device=t.device) % 1_000_003 + 1
    return int((t.reshape(-1).long() * w).sum())


def table_state(fa, device, k):
    """(sa, rank, tied, n, n1) of the table build's first tied state."""
    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import probe_span, sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_tables,
                                          pack_keys)

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
    return sa, rank, tied, n, n1


def kk_probe(cs, fa, device):
    import torch

    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.kernels import ties as kt

    k = 20
    sa, rank, tied, n, n1 = table_state(fa, device, k)
    first = int(tied.sum())
    cap = max(1024, n // 8)
    # the order sa: the parent's signatures; position order: this design's
    by_order = "sa" in inspect.signature(kt.full_round_keys).parameters
    kk_args = (sa, rank, k, n1) if by_order else (rank, k, n1)
    tag = (f"table_repeats first full round k={k} n={n} ({first} tied, "
           f"cap {cap}; keys {'through sa' if by_order else 'in position order'})")
    print(f"{tag}", flush=True)

    kk = lambda: kt.full_round_keys(*kk_args)  # noqa: E731
    key = kk()
    want = kt.full_round_keys_plain(*kk_args)
    if not torch.equal(key, want):
        raise AssertionError(f"{tag}: KK differs from its plain version")
    del want
    floor = lambda: key.fill_(0)  # noqa: E731
    kk_b = cs.bound((20 if by_order else 12) * n, 8 * n)
    t = [timed(cs, f) for f in (kk, floor, floor, kk)]
    print(f"KK full_round_keys: {t[0]} / {t[3]} ms; store-only floor "
          f"(fill_ of its {8 * n} B) {t[1]} / {t[2]} ms; bound "
          f"{kk_b[0]:.4f} ms ({kk_b[1]}; 12 B a row in position order, "
          f"20 through sa)", flush=True)
    key = kk()
    sort = lambda: torch.sort(key, stable=True)  # noqa: E731
    print(f"sort (torch.sort, stable, {n} int64 keys): {timed(cs, sort)} ms",
          flush=True)
    skey, order = sort()

    rank_k, rank_p = rank.clone(), rank.clone()
    kl_args = ((skey, order, sa) if by_order else (skey, order))
    kl = lambda: kt.full_round_refine(*kl_args, rank_k, n1)  # noqa: E731
    new_sa, tied_k = kl()
    want_sa, want_tied = kt.full_round_refine_plain(*kl_args, rank_p, n1)
    if not (torch.equal(new_sa, want_sa) and torch.equal(tied_k, want_tied)
            and torch.equal(rank_k, rank_p)):
        raise AssertionError(f"{tag}: KL differs from its plain version")
    print(f"round checksums: new_sa {checksum(new_sa)}, rank "
          f"{checksum(rank_k)}, tied {int(tied_k.sum())}", flush=True)
    del want_sa, want_tied, rank_p
    # KL's in-order pass alone, the library's entry on buffers made once
    lib = _build.lib()
    stream = _build.stream_of(skey)
    o_sa = torch.empty(n, dtype=torch.int32, device=device)
    o_s = torch.empty(n, dtype=torch.int32, device=device)
    o_t = torch.empty(n, dtype=torch.bool, device=device)
    head = (skey.data_ptr(), order.data_ptr()) + (
        (sa.data_ptr(),) if by_order else ())

    def inorder():
        _build.check(lib.asgart_full_round_refine(
            *head, n, n1, o_sa.data_ptr(), o_s.data_ptr(), o_t.data_ptr(),
            stream), "full_round_refine")

    kl_b = cs.bound((29 if by_order else 25) * n, 20 * n)
    t = [timed(cs, f) for f in (kl, inorder, inorder, kl)]
    print(f"KL full_round_refine: {t[0]} / {t[3]} ms; its in-order pass "
          f"alone {t[1]} / {t[2]} ms; bound {kl_b[0]:.4f} ms ({kl_b[1]})",
          flush=True)
    del o_sa, o_s, o_t, new_sa, tied_k
    torch.cuda.empty_cache()

    del key, skey, order
    round_kk = (sa, rank_k, k, n1) if by_order else (rank_k, k, n1)

    def one_round():
        rank_k.copy_(rank)
        key = kt.full_round_keys(*round_kk)
        sk, od = torch.sort(key, stable=True)
        del key
        args = (sk, od, sa) if by_order else (sk, od)
        return kt.full_round_refine(*args, rank_k, n1)

    torch.cuda.empty_cache()
    copy = lambda: rank_k.copy_(rank)  # noqa: E731
    t = [timed(cs, f) for f in (one_round, copy, copy, one_round)]
    print(f"whole round (rank copy, KK, sort, KL): {t[0]} / {t[3]} ms; the "
          f"rank copy alone {t[1]} / {t[2]} ms", flush=True)
    print(f"profile of one round: {cs.kernel_profile(one_round)}",
          flush=True)
    del rank_k
    torch.cuda.empty_cache()

    walls = []
    for _ in range(RUNS):
        s, r, td = sa.clone(), rank.clone(), tied.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.time()
        s, td, h = ties_mod.full_rounds(s, r, td, k, cap, n1)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        peak = torch.cuda.max_memory_allocated() - held
        still = int(td.sum())
        del s, r, td
        torch.cuda.empty_cache()
    print(f"ties.full_rounds from the first tied state: "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (host clock + sync), "
          f"{still} still tied at h={h}; its peak above the state it was "
          f"given {peak} B ({peak / n:.2f} B a row)", flush=True)
    del sa, rank, tied
    torch.cuda.empty_cache()


def dir_case(cs, tag, skey, k):
    import torch

    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.kernels.merge_join import (mj_directory,
                                                     mj_directory_plain)

    W = skey.numel()
    d = mj_directory(skey, k)
    flag = getattr(d, "flag", None)
    if flag is not None and int(flag.item()):
        raise AssertionError(f"{tag}: the directory flagged sorted keys")
    want = mj_directory_plain(skey, k, d.bits)
    if not torch.equal(d.table, want.table):
        raise AssertionError(f"{tag}: the directory differs from its plain "
                             "version")
    lib = _build.lib()
    table = torch.empty_like(d.table)
    bad = torch.empty(1, dtype=torch.int32, device=skey.device)
    stream = _build.stream_of(skey)

    def entry():
        _build.check(lib.asgart_mj_directory(
            skey.data_ptr(), W, k, d.bits, table.data_ptr(), bad.data_ptr(),
            stream), "mj_directory")

    def read():
        got = mj_directory(skey, k)
        f = getattr(got, "flag", None)
        if f is not None:
            f.item()

    wrap = lambda: mj_directory(skey, k)  # noqa: E731
    t = [timed(cs, f) for f in (entry, wrap, read, read, wrap, entry)]
    b = cs.bound(8 * W + 4 * d.table.numel(), 4 * W)
    print(f"mj_directory {tag} ({W} keys, 2^{d.bits} buckets): entry "
          f"{t[0]} / {t[5]} ms; wrapper {t[1]} / {t[4]} ms; wrapper and "
          f"flag read {t[2]} / {t[3]} ms; bound {b[0]:.4f} ms ({b[1]})",
          flush=True)


def dir_probe(cs, fa, device):
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import pack_keys
    from asgart_tpu_torch.pipeline import plan_windows

    k = 20
    _, _, strand = prepare_data([fa], False, None)
    n = len(strand.data) - 1
    codes = upload_codes(strand.data, device)
    wins = (("mj_trim window", (3 * n // 8, 5 * n // 8)),
            ("shards window 2", plan_windows(n, 4)[2]))
    for name, (ws, we) in wins:
        W = we - ws + 1
        keys, _ = pack_keys(codes, (), k, True, True, W, 0, ws)
        (skey,), _ = sort_keys(keys)
        dir_case(cs, f"{name} (ws={ws})", skey, k)
        if name.startswith("mj_trim"):
            Wl = -(-W // 4)
            dir_case(cs, f"rank shard 1 of 4 of the {name} (rows {Wl}.."
                     f"{2 * Wl})", skey[Wl:2 * Wl].clone(), k)
        del skey
        torch.cuda.empty_cache()


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
        print("kk_dir_probe: CUDA is not available", file=sys.stderr)
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
    work = os.path.join(HERE, "build", "kk_dir_probe")
    os.makedirs(work, exist_ok=True)
    fr = write_fa(os.path.join(work, "repeats.fa"),
                  cs.repeat_genome(int(args.repeats_mbp * 1e6)))
    kk_probe(cs, fr, device)
    torch.cuda.empty_cache()
    g = synthetic_genome(int(args.mbp * 1e6), np.random.default_rng(cs.SEED))
    fa = write_fa(os.path.join(work, "genome.fa"), g)
    del g
    dir_probe(cs, fa, device)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
