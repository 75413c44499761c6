"""GPU smoke run of the PyTorch / CUDA port (asgart_tpu_torch) on one card.

    python3 chip_smoke.py            # the full run: 128 Mbp, -RC, six paths
    python3 chip_smoke.py --mbp 4    # a quick run at a smaller genome

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from asgart_tpu_torch/csrc with nvcc;
3. runs six paths on ``asgart_tpu_torch.synthetic.synthetic_genome``
   (the repo benchmark's genome, fixed seed) written as
   FASTA, all -RC: the whole genome at k = 20 (one-word keys) and k = 25
   (two-word keys); ``--shards 4`` at k = 20; one trim window in the
   middle of the genome at k = 25; and, with a ballast tensor on the card
   that leaves too little memory for the fused build, the merge-join
   window engine on the same middle window at k = 20 (``mj_trim``) and on
   the ``--shards 4`` windows (``mj_shards``, held to the shards path's
   host JSON; its checks on window 2). For each path:
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
      the merge-join paths each window's build peak per window row and
      its stage 1 and scans' peak per probe lane (the readings behind
      ``MJ_PEAK_BYTES_PER_ROW`` and ``MJ_BYTES_PER_LANE``);
   c. runs the host engine once (the first run also builds the native
      chain library, which the timed runs then find built);
   d. drives the path through the user entry point
      ``asgart_tpu_torch.pipeline.search_duplications(engine="cuda")``
      twice (whole genome and trim: cold, then a device index cache hit;
      shards: two full runs, the windows are not cached), with every
      launch counter set to 0 just before and read just after; requires
      the JSON bytes of all three runs to be equal and every kernel of
      the path to have been launched (mj_trim: the cache hit launches
      neither KA nor KH; mj_shards: KA packs the probe keys once a run);
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
MJ = WINDOW + ("mj_ranges",)  # the merge-join window engine


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


def recorder(rows: list, path: str, k: int):
    """``record(name, src, replaces, err, ms, plain_ms, shape, nbytes, ops,
    library_ms=None)``: prints a kernel's line, raises if it disagrees with
    its plain version, and appends its row to ``rows``."""
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

    return record


def tie_checks(record, tag: str, sa, rank, tied, M: int, k: int, device):
    """KE / KF on the first tie round (the largest tied set) against their
    plain versions, then the whole tie resolution with KE/KF and with
    their plain versions in the same rounds, in turns (plain, kernel,
    kernel, plain). Returns the resolved ``sa``."""
    import torch

    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.kernels import tie_keys, tie_refine
    from asgart_tpu_torch.kernels.ties import (tie_keys_plain,
                                               tie_refine_plain)

    # KF writes sa and rank in place, so each side gets its own copies (KF
    # reads neither, so repeated calls write the same values)
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
    print(f"{tag} tie resolution of {n_tied} tied rows: KE/KF "
          f"{' / '.join(f'{t:.4f}' for t in times[False])} s, plain rounds "
          f"{' / '.join(f'{t:.4f}' for t in times[True])} s (host clock + "
          "sync)", flush=True)
    return finals[False]


def kg_check(record, sa, ws: int) -> None:
    """KG on a window's final suffix order: kernel, plain version and the
    one PyTorch call (the plain version is that call), each on its own
    copy, so every timed launch adds ws to the same values; then ``sa +=
    ws`` in place."""
    from asgart_tpu_torch.kernels import offset_slots
    from asgart_tpu_torch.kernels.window import offset_slots_plain

    M = sa.numel()
    copies = [sa.clone() for _ in range(3)]
    kg = lambda: offset_slots(copies[0], ws)  # noqa: E731
    pg = lambda: offset_slots_plain(copies[1], ws)  # noqa: E731
    lg = lambda: copies[2].add_(ws)  # noqa: E731
    err = max_abs_err((kg(),), (pg(),))
    ms, plain_ms, lib_ms = cuda_ms(kg), cuda_ms(pg), cuda_ms(lg)
    record("offset_slots", "window.cu", "asgart_tpu/device_index.py:1505",
           err, ms, plain_ms, f"{M} slots, ws={ws}", 8 * M, M,
           library_ms=lib_ms)
    del copies
    offset_slots(sa, ws)


def kd_check(record, settings, specs, lane_off, lane_lo, lane_hi, lane_mask,
             sa) -> None:
    """KD on the largest chunk's lanes, as the engines call it."""
    import torch

    from asgart_tpu_torch.kernels import scan_core
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain

    s = settings
    c = max(range(len(specs)), key=lambda i: specs[i][2])
    cs, cl, nc = specs[c]
    lanes = slice(lane_off[c], lane_off[c] + nc)
    args = (lane_lo[lanes], lane_hi[lanes], lane_mask[lanes], sa, cs, cl,
            s.max_cardinality, 0, s.probe_size, s.reverse)
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

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
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

    sa = tie_checks(record, tag, sa, rank, tied, M, k, device)
    del rank, tied
    if ws:
        kg_check(record, sa, ws)
    kd_check(record, s, specs, lane_off, lane_lo, lane_hi, lane_mask, sa)
    return rows, M


def mj_kernel_checks(fa: str, path: str, settings, device, trim
                     ) -> tuple[list, int, int]:
    """Each kernel of the merge-join window engine against its plain
    version at the shapes of the window ``trim`` probed by the whole
    genome: KA's window keys and probe-only mode (one row), the sort, KB,
    KC with no lanes, KE/KF, KG, KH and KD on the largest chunk. Returns
    (kernel rows, W, probe lanes)."""
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          mj_ranges, pack_keys)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.merge_join import mj_ranges_plain
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

    codes = upload_codes(strand.data, device)
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
    times = [cuda_ms(f) for f in (kaw, paw, kap, pap)]
    print(f"{tag} KA window keys (W={W}, ws={ws}): max_abs_err={err_w} "
          f"kernel {times[0]:.3f} ms, plain {times[1]:.3f} ms; probe-only "
          f"({total} lanes): max_abs_err={err_p} kernel {times[2]:.3f} ms, "
          f"plain {times[3]:.3f} ms", flush=True)
    record("pack_keys", "pack_keys.cu",
           "asgart_tpu/device_engine.py:904 + asgart_tpu/device_index.py:269",
           max(err_w, err_p), times[0] + times[2], times[1] + times[3],
           f"W={W}, ws={ws} window keys + {total} probe keys",
           W + 8 * W + n1 + 9 * total, (W + total) * (4 * k + 8))
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
           err, cuda_ms(kc), cuda_ms(pc), f"W={W}, no lanes", 12 * W, W,
           library_ms=cuda_ms(lc))
    if not torch.equal(lib, rank):
        raise AssertionError(f"index_put_ differs from KC on {tag}")
    del run_lo, run_hi, sa64, lib

    sa = tie_checks(record, tag, sa, rank, tied, W, k, device)
    del rank, tied
    kg_check(record, sa, ws)

    kh = lambda: mj_ranges(skey, pkey, pmask, lane_off)  # noqa: E731
    ph = lambda: mj_ranges_plain(skey, pkey, pmask, lane_off)  # noqa: E731
    lane_lo, lane_hi, totals = kh()
    err = max_abs_err((lane_lo, lane_hi, totals), ph())
    sk, pk = skey >> 1, pkey >> 1  # the flag-free keys
    ends = torch.tensor(lane_off[1:], device=device) - 1

    def lh():  # the two searchsorted calls and the masked sums
        lo = torch.searchsorted(sk, pk, side="left")
        hi = torch.searchsorted(sk, pk, side="right")
        return torch.where(pmask, hi - lo, 0).cumsum(0)[ends]

    lib_ms = cuda_ms(lh)
    csum = lh()
    if not torch.equal(csum - torch.cat([csum.new_zeros(1), csum[:-1]]),
                       totals):
        raise AssertionError(f"torch.searchsorted totals differ from KH on "
                             f"{tag}")
    n_masked = int(pmask.sum())
    steps = max(1, W.bit_length())
    record("mj_ranges", "merge_join.cu", "asgart_tpu/device_engine.py:788",
           err, cuda_ms(kh), cuda_ms(ph),
           f"{total} lanes ({n_masked} masked in) against W={W}",
           8 * total + 9 * total + 8 * W, n_masked * 4 * steps,
           library_ms=lib_ms)
    del sk, pk, skey, pkey

    kd_check(record, s, specs, lane_off, lane_lo, lane_hi, pmask, sa)
    return rows, W, total


def mj_peaks(fa: str, settings, windows, device) -> float:
    """Each window's merge-join build alone, with the codes uploaded once
    beside it: its peak device bytes above what was allocated before it,
    per window row; then its stage 1 and scans (the engine over the built
    index): their peak above the index and codes, per probe lane. Returns
    the largest build peak in bytes (codes included)."""
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
        print(f"mj k={k} window ({ws}, {we}): build "
              f"peak {peak - base} B above the {base} B resident = "
              f"{(peak - base) / idx.W:.2f} B per window row ({idx.W} rows; "
              f"MJ_PEAK_BYTES_PER_ROW = {MJ_PEAK_BYTES_PER_ROW}); stage 1 "
              f"and scans peak {peak1 - held} B above the {held} B of index "
              f"and codes = {(peak1 - held) / lanes:.2f} B per probe lane "
              f"({lanes} lanes; MJ_BYTES_PER_LANE = {MJ_BYTES_PER_LANE})",
              flush=True)
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
                min_sds: int = 1) -> list:
    """A merge-join path, which the router takes because a ballast tensor
    (:func:`mj_ballast`, held for the path's two runs) leaves too little
    memory for the fused build: the kernel checks (the trim window, or
    window 2 of the shards), each window's build and stage-1 peaks, the
    host engine unless its JSON ``host`` is given, then two runs through
    the user entry point (trim: cold, then a cache hit that launches
    neither KA nor KH; shards: two full runs, each packing the probe keys
    once), with every launch counter set to 0 just before and read after
    each run. Returns the path's kernel rows with their main-path launch
    counts."""
    import torch

    from asgart_tpu_torch import kernels as kmod
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

    # the first window is the largest; the genome is one record (n + '$')
    ws, we = windows[0]
    ballast, nb = mj_ballast(n + 1, we - ws + 1, k, shards > 1, device)
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
        del ballast

    for tag2, (t, text, prof, c) in runs.items():
        print(f"{tag} cuda {tag2}: {t:.3f} s wall, {n / 1e6 / t:.2f} Mbp/s, "
              f"phases {json.dumps(prof)}, launches {json.dumps(c)}")
    n_sds = sum(len(f) for f in json.loads(host)["families"])
    print(f"{tag} JSON {len(host)} bytes, {n_sds} SDs; peak device memory "
          f"of the cold run {peak} B (ballast excluded) against the largest "
          f"window build alone {largest} B ({W} window rows, {lanes} probe "
          "lanes)")
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
    elif runs["warm"][3]["pack_keys"] or runs["warm"][3]["mj_ranges"]:
        raise AssertionError(f"{tag} warm run (a cache hit) launched KA or "
                             "KH")
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
                                                            **rc))[0]
    shard_rows, shard_host = run_path(fa, n, device, "shards",
                                      RunSettings(probe_size=20, **rc),
                                      shards=SHARDS, kernels=WINDOW)
    rows += shard_rows
    # a quarter of the genome around its middle (its N run), two-word
    # keys; at the default size it holds planted -RC pairs (a quick run's
    # smaller genome may have none there)
    trim = (3 * n // 8, 5 * n // 8)
    min_sds = 1 if args.mbp >= 100 else 0
    rows += run_path(fa, n, device, "trim", RunSettings(probe_size=25,
                                                       trim=trim, **rc),
                     kernels=WINDOW, min_sds=min_sds)[0]
    # the merge-join window engine, routed there by a ballast tensor: the
    # same middle window at k = 20, and the shards path's windows, whose
    # JSON is the host JSON the fused shards path computed
    rows += run_mj_path(fa, n, device, "mj_trim",
                        RunSettings(probe_size=20, trim=trim, **rc),
                        min_sds=min_sds)
    rows += run_mj_path(fa, n, device, "mj_shards",
                        RunSettings(probe_size=20, **rc), shards=SHARDS,
                        host=shard_host)
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
