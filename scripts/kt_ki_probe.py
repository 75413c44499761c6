"""KT and KI on one H100, apart from chip_smoke.py's paths.

    python3 scripts/kt_ki_probe.py [--root DIR] [--mbp 128] [--big-mbp 3100]
                                   [--parts kt,ki]

``--root`` is the checkout whose ``asgart_tpu_torch`` is measured (default:
this one), so that two versions are compared in one call; the helpers
(``cuda_ms``, ``kernel_ms``, ``bound``, ``smi_line``, ``free_port``) come
from this checkout's chip_smoke.py. Every time is a 20-call mean (CUDA
events): the wrapper's call, and its launches alone behind a busy-wait on
the card (``kernel_ms``; "waits" where the call waits for the card).

KT ``gather_owned`` on the largest chunk (by raw total) of chip_smoke's
mj_trim window (k = 20, -RC, the middle quarter of the ``--mbp``
synthetic genome, seed 1234) with the bounds of a one-rank stage 1: on
the one rank's whole window (rank_trim) and on each of four ranks' shards
(rank_trim4), against its plain version, beside its bound, a read-only
floor of the lane stream (three reductions: ``lane_lo``, ``lane_hi``,
``lane_mask``) and a ``zero_`` of the buffer (what a memset before the
kernel would add); then the whole ``ShardedWindowEngine.gather`` in a
one-rank NCCL group (``csr_offsets``' cumsum and its host read, KT, the
one-rank ``all_reduce``, the two casts), and, where the engine takes it,
with the chunk's total handed in (no host read).

KI ``unpack_codes`` on the ``--mbp`` genome's strand (its own packing) and
on a ``--big-mbp`` strand (random packed bytes and one exception every
100 kb, made on the card): n4 % 4 and the path the package's design takes
there, against its plain version, beside its bound, a store-only
``fill_`` floor of its n1 output bytes and ``packed.repeat(4)``, a library
copy that reads and writes the kernel's bytes. (The tie rounds are
measured by scripts/km_kf_probe.py.) Prints one line per measurement, the
card first. Needs a CUDA GPU.
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
K = 20


def smoke():
    """This checkout's chip_smoke.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def alone_ms(cs, fn) -> float | None:
    """``fn``'s launches alone (a 20-call mean), or None where ``fn`` waits
    for the card."""
    try:
        return cs.kernel_ms(fn, REPS)
    except AssertionError:
        return None


def alone(cs, fn) -> str:
    a = alone_ms(cs, fn)
    return "waits for the card" if a is None else f"alone {a:.4f}"


def timed(cs, fn) -> str:
    return f"{cs.cuda_ms(fn, REPS):.4f} ({alone(cs, fn)})"


def settings(trim=None):
    from asgart_tpu_torch.structs import RunSettings

    return RunSettings(probe_size=K, trim=trim, reverse=True,
                       complement=True)


def kt_case(cs, tag, lanes, off, total, shard, eng):
    import torch

    from asgart_tpu_torch.kernels import gather_owned
    from asgart_tpu_torch.kernels.sharded import gather_owned_plain

    lo, hi, mask = lanes
    n = lo.numel()
    args = (*lanes, off, total, shard.sa, shard.row0)
    got = gather_owned(*args)
    if not torch.equal(got, gather_owned_plain(*args)):
        raise AssertionError(f"{tag}: KT differs from its plain version")
    lo64, hi64 = lo.to(torch.int64), hi.to(torch.int64)
    live = int(((hi64 > lo64) & mask).sum())
    span = (hi64.clamp(max=shard.row0 + shard.sa.numel())
            - lo64.clamp(min=shard.row0)).clamp(min=0)
    owned = int(torch.where(mask, span, 0).sum())
    b = cs.bound(9 * n + 8 * live + 4 * total + 4 * owned, 2 * total)
    kt = lambda: gather_owned(*args)  # noqa: E731
    floor = lambda: (lo.sum(), hi.sum(), mask.sum())  # noqa: E731
    zero = lambda: got.zero_()  # noqa: E731
    t = [timed(cs, f) for f in (kt, floor, zero, kt)]
    plain = cs.cuda_ms(lambda: gather_owned_plain(*args), REPS)
    print(f"KT gather_owned {tag} ({n} lanes, {live} with entries, {total} "
          f"entries, {owned} owned, rows {shard.row0}..+{shard.sa.numel()})"
          f": {t[0]} / {t[3]} ms; plain {plain:.4f}; read-only floor of the "
          f"lane stream (three reductions) {t[1]}; zero_ of the buffer "
          f"{t[2]}; bound {b[0]:.4f} ms ({b[1]})", flush=True)
    old = eng.index
    eng.index = shard
    try:
        whole = timed(cs, lambda: eng.gather(*lanes))
        line = f"ShardedWindowEngine.gather {tag}: {whole} ms"
        if "total" in inspect.signature(eng.gather).parameters:
            with_total = timed(cs, lambda: eng.gather(*lanes, total))
            line += f"; with the chunk's total handed in {with_total} ms"
        print(line, flush=True)
    finally:
        eng.index = old


def kt_probe(cs, fa, n, device):
    import torch

    from asgart_tpu_torch import distributed
    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import ShardedWindowEngine
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.kernels.sharded import csr_offsets
    from asgart_tpu_torch.window_index import ShardedWindowIndex

    trim = (3 * n // 8, 5 * n // 8)
    s = settings(trim)
    distributed.init(0, 1, device, f"tcp://127.0.0.1:{cs.free_port()}")
    try:
        trim_, chunks, strand = prepare_data([fa], s.skip_masked, s.trim)
        eng = ShardedWindowEngine(strand, s, device, trim_)
        idx = eng.ensure_index()
        ranges = eng.stage1(chunks)
        n_lanes = {(cs_, cl): nc for cs_, cl, nc in ranges.specs}
        chunk = max(n_lanes, key=lambda c: ranges.offs[c][1])
        off0, _ = ranges.offs[chunk]
        lanes = [t[off0: off0 + n_lanes[chunk]] for t in
                 (ranges.lane_lo, ranges.lane_hi, ranges.lane_mask)]
        off, total = csr_offsets(*lanes)
        print(f"KT: mj_trim window {trim}, largest chunk {chunk}", flush=True)
        kt_case(cs, "rank_trim (1 rank)", lanes, off, total, idx, eng)
        codes = upload_codes(strand.data, device)
        for r in range(4):
            shard = ShardedWindowIndex.build(
                strand.data, s.probe_size, trim_, s.reverse, s.complement,
                device, r, 4, False, codes)
            kt_case(cs, f"rank_trim4 rank {r} of 4", lanes, off, total, shard,
                    eng)
            del shard
        del codes, eng, idx, ranges, lanes, off
    finally:
        distributed.dist.destroy_process_group()
    torch.cuda.empty_cache()


def design(root) -> str:
    with open(os.path.join(root, "asgart_tpu_torch", "csrc",
                           "codes.cu")) as fh:
        return "tiles" if "kTile" in fh.read() else "words"


def ki_case(cs, tag, p, pos, code, n1, root):
    import torch

    from asgart_tpu_torch.kernels import unpack_codes
    from asgart_tpu_torch.kernels.codes import unpack_codes_plain

    n4 = p.numel()
    got = unpack_codes(p, pos, code, n1)
    if not torch.equal(got, unpack_codes_plain(p, pos, code, n1)):
        raise AssertionError(f"{tag}: KI differs from its plain version")
    if design(root) == "tiles":
        path = "tiles, 16-byte loads and stores at every n4"
    else:
        aligned = p.data_ptr() % 4 == 0 and got.data_ptr() % 4 == 0
        path = "wide (words)" if n4 % 4 == 0 and aligned else "byte"
    b = cs.bound(n4 + n1 + 10 * pos.numel(), 4 * n1)
    ki = lambda: unpack_codes(p, pos, code, n1)  # noqa: E731
    fill = lambda: got.fill_(0)  # noqa: E731
    # a library copy with the kernel's traffic: n4 bytes read, 4 n4 written
    rep = lambda: p.repeat(4)  # noqa: E731
    t = [timed(cs, f) for f in (ki, fill, rep, fill, ki)]
    plain = cs.cuda_ms(lambda: unpack_codes_plain(p, pos, code, n1), 3)
    print(f"KI unpack_codes {tag} (n1={n1}, n4={n4}, n4 % 4 = {n4 % 4}, "
          f"{pos.numel()} exceptions; path: {path}): {t[0]} / {t[4]} ms; "
          f"plain {plain:.4f} (3 calls); store-only floor (fill_ of {n1} B) "
          f"{t[1]} / {t[3]}; `packed.repeat(4)` ({n4} B read, {4 * n4} B "
          f"written) {t[2]}; bound {b[0]:.4f} ms ({b[1]})", flush=True)
    del got
    torch.cuda.empty_cache()


def ki_probe(cs, fa, big_mbp, device, root):
    import torch

    from asgart_tpu_torch.codes import pack_codes
    from asgart_tpu_torch.fasta import prepare_data

    _, _, strand = prepare_data([fa], False, None)
    n1 = len(strand.data)
    p, pos, code = (torch.from_numpy(a).to(device)
                    for a in pack_codes(strand.data))
    ki_case(cs, f"{n1 // 10**6} Mbp strand", p, pos, code, n1, root)
    del p, pos, code
    if not big_mbp:
        return
    n1 = int(big_mbp * 1e6) + 1
    n4 = -(-n1 // 4)
    g = torch.Generator(device=device)
    g.manual_seed(1234)
    p = torch.randint(0, 256, (n4,), dtype=torch.uint8, device=device,
                      generator=g)
    pos = torch.arange(50_000, n1 - 1, 100_000, device=device)
    pos = torch.cat([pos, torch.tensor([n1 - 1], device=device)])
    code = torch.full((pos.numel(),), 4, dtype=torch.uint8, device=device)
    code[-1] = 0
    ki_case(cs, f"{big_mbp:g} Mbp strand (random packing)", p, pos, code,
            n1, root)
    del p, pos, code
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose asgart_tpu_torch is measured")
    ap.add_argument("--mbp", type=float, default=128.0)
    ap.add_argument("--big-mbp", type=float, default=3100.0,
                    help="KI's second strand in Mbp (0: none)")
    ap.add_argument("--parts", default="kt,ki",
                    help="what to measure, of kt and ki")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kt_ki_probe: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = smoke()
    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.synthetic import synthetic_genome

    print(cs.smi_line())
    print(f"measured package: {root}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    _build.lib()
    print(f"kernel library built and loaded in {time.time() - t0:.1f} s",
          flush=True)
    device = cuda_device()
    work = os.path.join(HERE, "build", "kt_ki_probe")
    os.makedirs(work, exist_ok=True)
    n = int(args.mbp * 1e6)
    g = synthetic_genome(n, np.random.default_rng(cs.SEED))
    fa = os.path.join(work, "genome.fa")
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + g.tobytes() + b"\n")
    del g
    if "kt" in parts:
        kt_probe(cs, fa, n, device)
    if "ki" in parts:
        ki_probe(cs, fa, args.big_mbp, device, root)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
