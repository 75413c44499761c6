"""KM, KJ and the tie rounds' KF on one H100, apart from chip_smoke.py's
paths.

    python3 scripts/km_kf_probe.py [--root DIR] [--mbp 128]
                                   [--repeats-mbp 64] [--parts km,kj,kf]

``--root`` is the checkout whose ``asgart_tpu_torch`` is measured (default:
this one), so that two versions are compared in one call; the helpers
(``cuda_ms``, ``kernel_ms``, ``bound``, ``smi_line``, ``repeat_genome``)
come from this checkout's chip_smoke.py. Every time is a 20-call mean
(CUDA events): the wrapper's call, and its launches alone behind a
busy-wait on the card (``kernel_ms``; "waits" where the call waits for
the card).

KM ``table_ranges`` on the table engine's index of chip_smoke's ``table``
(k = 20, -RC, the ``--mbp`` synthetic genome, seed 1234), ``table_k25``
(k = 25) and ``table_repeats`` (k = 20, the ``--repeats-mbp`` repeat-dense
genome): the wrapper, and KM alone. A package whose wrapper copies its
chunk table from pageable memory (it waits for the card) is timed alone
through its library entry with the table uploaded beforehand. Beside it,
on the same lanes over plain-layout planes (position x at x): a
read-only floor of the strided access (both planes summed over each
chunk's strided view at KM's x), a floor of a contiguous read of the same
8 B a lane plus KM's stores (two ``copy_`` and a ``fill_``), and
``index_select`` twice plus the masks (chip_smoke's library call). A
package whose wrapper can pass the chunk table in the launch is timed
again with every chunk table copied from pinned memory instead (its
``KM_OFF_CAPACITY`` set to 0 for the call).

KJ ``invert_tables`` on ``table``'s text rows (and, where the package
writes the decimated planes, at step 1 too).

KF ``tie_refine`` round by round over the whole k = 20 -RC fused build of
the ``--mbp`` genome, then over the subset rounds of the k = 20 -RC table
build of the ``--repeats-mbp`` genome, after its full rounds
(``ties.resolve_ties``' loop): the tied count, KE,
the stable sort, KF alone, and the round's tail as the package runs it
(a package whose KF does not compact: KF, the cumsum, the stack of the
count and the flag, the where and three ``scatter_``; else KF alone), and
the round's host read (host clock, after a synchronize). Prints one line
per measurement, the card first. Needs a CUDA GPU.
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


def alone_ms(cs, fn) -> float | None:
    """``fn``'s launches alone (a 20-call mean), or None where ``fn`` waits
    for the card."""
    try:
        return cs.kernel_ms(fn, REPS)
    except AssertionError:
        return None


def timed(cs, fn) -> str:
    a = alone_ms(cs, fn)
    return (f"{cs.cuda_ms(fn, REPS):.4f} ("
            + ("waits for the card" if a is None else f"alone {a:.4f}")
            + ")")


def decimated_tables() -> bool:
    """Whether the measured package keeps the table planes decimated (its
    DeviceIndex has a decimation ``step``)."""
    from asgart_tpu_torch.table_index import DeviceIndex

    return hasattr(DeviceIndex, "step")


def compacting_kf() -> bool:
    """Whether the measured package's KF compacts the still-tied entries
    (its kernel module has the compaction's tile, ``TIE_TILE``)."""
    from asgart_tpu_torch.kernels import ties

    return hasattr(ties, "TIE_TILE")


def plain_planes(idx):
    """The index's planes in plain position layout [n] (gathered where the
    package keeps them decimated)."""
    import torch

    if not decimated_tables():
        return idx.pos_lo, idx.pos_hi
    from asgart_tpu_torch.kernels.tables import decimated_index

    at = decimated_index(torch.arange(idx.n, device=idx.pos_lo.device),
                         idx.step, idx.C)
    return tuple(t[at] for t in (idx.pos_lo, idx.pos_hi))


def km_alone_parent(cs, idx, specs, k, rc):
    """KM alone through a plain-layout package's library entry, its chunk
    table on the card beforehand (its wrapper copies it from pageable
    memory, so it waits for the card)."""
    import torch

    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.kernels.tables import table_x0s

    dev = idx.pos_lo.device
    lane_off, x0s, cls = table_x0s(specs, idx.first_len, k, *rc)
    total, n_chunks = lane_off[-1], len(specs)
    off_t = torch.tensor(lane_off, dtype=torch.int64, device=dev)
    x0cl = torch.tensor([v for p in zip(x0s, cls) for v in p],
                        dtype=torch.int64, device=dev)
    lo, hi = (torch.empty(total, dtype=torch.int32, device=dev)
              for _ in range(2))
    mask = torch.empty(total, dtype=torch.bool, device=dev)
    totals = torch.empty(n_chunks, dtype=torch.int64, device=dev)
    lib = _build.lib()
    stream = _build.stream_of(idx.pos_lo)

    def km():
        _build.check(lib.asgart_table_ranges(
            idx.pos_lo.data_ptr(), idx.pos_hi.data_ptr(), idx.n,
            off_t.data_ptr(), x0cl.data_ptr(), n_chunks, k, total,
            lo.data_ptr(), hi.data_ptr(), mask.data_ptr(),
            totals.data_ptr(), stream), "table_ranges")

    return km


def km_case(cs, tag, fa, k, device):
    import torch

    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.kernels import table_ranges
    from asgart_tpu_torch.kernels.tables import table_x0s
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.table_index import DeviceIndex

    s = RunSettings(probe_size=k, reverse=True, complement=True)
    rc = (True, True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    idx = DeviceIndex.build(strand.data, k, *rc, device)
    km = lambda: table_ranges(idx.pos_lo, idx.pos_hi, specs, n1,  # noqa
                              k, *rc)
    lane_lo, lane_hi, lane_mask, totals, lane_off = km()
    total, n = lane_off[-1], idx.n
    step = k // 2
    wrapper = cs.cuda_ms(km, REPS)
    a = alone_ms(cs, km)
    how = "the wrapper"
    if a is None:
        a = cs.kernel_ms(km_alone_parent(cs, idx, specs, k, rc), REPS)
        how = "the library entry, its chunk table uploaded beforehand"
    b = cs.bound(17 * total, 12 * total)
    lo_p, hi_p = plain_planes(idx)
    _, x0s, cls = table_x0s(specs, n1, k, *rc)
    x = torch.cat([torch.arange(nc, device=device) * step + x0
                   for x0, (_, _, nc) in zip(x0s, specs)])
    live = torch.cat([torch.arange(nc, device=device) * step < cl - k - step
                      for (_, cl, nc) in specs]) & (x < n)
    xc = torch.where(live, x, 0)

    def lib():  # gathers at the probe positions, then the masks
        lo = lo_p.index_select(0, xc)
        mask = live & (lo >= 0)
        return (torch.where(mask, lo & 0x7FFFFFFF, 0),
                torch.where(mask, hi_p.index_select(0, xc), 0), mask)

    if any(not torch.equal(p, q) for p, q in zip(lib(), (lane_lo, lane_hi,
                                                         lane_mask))):
        raise AssertionError(f"{tag}: index_select differs from KM")
    views = []
    for x0, (_, _, nc) in zip(x0s, specs):
        m = max(0, min(nc, -(-(n - x0) // step)))
        views += [t.as_strided((m,), (step,), x0) for t in (lo_p, hi_p)]
    strided = lambda: [v.sum() for v in views]  # noqa: E731
    c_lo, c_hi = torch.empty_like(lane_lo), torch.empty_like(lane_hi)
    c_mask = torch.empty_like(lane_mask)

    def contiguous():  # 8 B a lane read in order, KM's 9 B stored
        c_lo.copy_(lo_p[:total])
        c_hi.copy_(hi_p[:total])
        c_mask.fill_(True)

    t_lib, t_str, t_con = (timed(cs, f) for f in (lib, strided, contiguous))
    pinned = ""
    if decimated_tables():
        from asgart_tpu_torch.kernels import tables as tables_mod

        cap = tables_mod.KM_OFF_CAPACITY
        tables_mod.KM_OFF_CAPACITY = 0  # every chunk table from pinned memory
        try:
            if any(not torch.equal(p, q) for p, q in zip(
                    km()[:4], (lane_lo, lane_hi, lane_mask, totals))):
                raise AssertionError(f"{tag}: KM's pinned-table path differs")
            pinned = (f"; the chunk table always from pinned memory: wrapper "
                      f"{timed(cs, km)}")
        finally:
            tables_mod.KM_OFF_CAPACITY = cap
    layout = (f"decimated (step {idx.step}, C {idx.C})"
              if decimated_tables() else "plain")
    print(f"KM table_ranges {tag} (k={k}, n={n} text rows, {total} lanes of "
          f"{len(specs)} chunks, planes {layout}): wrapper {wrapper:.4f} ms, "
          f"alone {a:.4f} ({how}); bound {b[0]:.4f} ({b[1]}); read-only "
          f"floor of the strided access (both plain planes summed over each "
          f"chunk's strided view) {t_str}; contiguous floor (8 B a lane read "
          f"in order + KM's 9 B stored: two copy_ and a fill_) {t_con}; "
          f"index_select x2 + masks {t_lib}{pinned}", flush=True)
    del idx, lane_lo, lane_hi, lane_mask, totals, lo_p, hi_p, x, live, xc
    del views
    del c_lo, c_hi, c_mask
    torch.cuda.empty_cache()


def km_probe(cs, fa, rfa, device):
    km_case(cs, "table", fa, 20, device)
    km_case(cs, "table_k25", fa, 25, device)
    km_case(cs, "table_repeats", rfa, 20, device)


def kj_probe(cs, fa, device):
    """KJ on the table build's text rows (k = 20, -RC)."""
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import group_bounds, invert_tables, pack_keys
    from asgart_tpu_torch.kernels.tables import invert_tables_plain

    k = 20
    _, _, strand = prepare_data([fa], False, None)
    n1 = len(strand.data)
    n = 2 * n1 - 1
    codes = upload_codes(strand.data, device)
    keys, _ = pack_keys(codes, (), k, True, True, n, 0, doubled=True)
    del codes
    skeys, sa = sort_keys(keys)
    del keys
    run_lo, run_hi, _ = group_bounds(skeys, sa, n1, flag_n_k=k,
                                     run_end=False)
    del skeys
    torch.cuda.empty_cache()
    if decimated_tables():
        from asgart_tpu_torch.kernels.tables import (decimated_index,
                                                     decimated_size)

        steps = [k // 2, 1]
        want = invert_tables_plain(sa, run_lo, run_hi, 1)
    else:
        steps = [None]
        want = invert_tables_plain(sa, run_lo, run_hi)
    for step in steps:
        if step is None:
            kj = lambda: invert_tables(sa, run_lo, run_hi)  # noqa: E731
            got = kj()
            plain = got
        else:
            kj = lambda: invert_tables(sa, run_lo, run_hi,  # noqa: E731
                                       step=step)
            got = kj()
            at = decimated_index(torch.arange(n, device=device), step,
                                 decimated_size(n, step)[0])
            plain = (got[0][at], got[1][at], got[2])
        if any(not torch.equal(p, q) for p, q in zip(plain, want)):
            raise AssertionError(f"KJ at step {step} differs from its plain "
                                 "version")
        del got, plain
        b = cs.bound(24 * n, 3 * n)
        print(f"KJ invert_tables table (n={n} text rows, "
              f"{'plain planes' if step is None else f'step {step}'}): "
              f"{timed(cs, kj)} ms; bound {b[0]:.4f} ({b[1]})", flush=True)
    del sa, run_lo, run_hi, want
    torch.cuda.empty_cache()


def fused_tie_state(fa, device):
    """(sa, rank, tied, M) of the whole k = 20 -RC fused build, before its
    tie resolution."""
    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import fused_layout, sort_keys
    from asgart_tpu_torch.kernels import group_bounds, invert_fused, pack_keys
    from asgart_tpu_torch.structs import RunSettings

    s = RunSettings(probe_size=20, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    W, total, lane_off = fused_layout(n1, specs)
    codes = upload_codes(strand.data, device)
    keys, lane_mask = pack_keys(codes, specs, 20, True, True, W, total, 0)
    del codes
    skeys, sa = sort_keys(keys)
    run_lo, run_hi, tied = group_bounds(skeys, sa, W)
    del skeys
    rank, _, _, _ = invert_fused(sa, run_lo, run_hi, lane_mask, W, lane_off)
    return sa, rank, tied, W + total, 20


def table_tie_state(fa, device):
    """(sa, rank, tied, M, h) of the k = 20 -RC table build, after its full
    rounds and before its subset rounds (``DeviceIndex.build``'s steps at
    the default ``tied_cap``; rank cut to the direct text, as the subset
    rounds read it)."""
    import torch

    from asgart_tpu_torch.codes import upload_codes
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import group_bounds, invert_tables, pack_keys
    from asgart_tpu_torch.ties import full_rounds

    k = 20
    _, _, strand = prepare_data([fa], False, None)
    n1 = len(strand.data)
    n = 2 * n1 - 1
    codes = upload_codes(strand.data, device)
    keys, _ = pack_keys(codes, (), k, True, True, n, 0, doubled=True)
    del codes
    skeys, sa = sort_keys(keys)
    del keys
    run_lo, run_hi, tied = group_bounds(skeys, sa, n1, flag_n_k=k,
                                        run_end=False)
    del skeys
    args = (k // 2,) if decimated_tables() else ()
    _, _, rank = invert_tables(sa, run_lo, run_hi, *args)
    del run_lo, run_hi
    torch.cuda.empty_cache()
    sa, tied, h = full_rounds(sa, rank, tied, k, max(1024, n // 8), n1)
    return sa, rank[:n1], tied, n, h


def kf_probe(cs, label, state, device):
    """``ties.resolve_ties``' subset loop from ``state`` (sa, rank, tied,
    M, h), each step of each round timed on that round's state before the
    round advances."""
    import torch

    from asgart_tpu_torch.kernels import tie_keys, tie_refine
    from asgart_tpu_torch.kernels.ties import tie_refine_plain

    sa, rank, tied, M, h = state
    del state
    slots = torch.nonzero(tied).flatten()
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(torch.int32)
    new = compacting_kf()
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    bad, count = flags[:1], flags[1:]
    print(f"tie rounds of {label} (M={M}, {slots.numel()} tied rows at "
          f"h={h}; KF {'compacts' if new else 'does not compact'})",
          flush=True)
    rnd, sums = 0, {}
    while h < 2 * M:
        rnd += 1
        n_t = ps.numel()
        ke = lambda: tie_keys(ps, prims, rank, min(h, M), bad)  # noqa: E731
        key = ke()
        sort = lambda: torch.sort(key, stable=True)  # noqa: E731
        skey, order = sort()
        # KF reads neither sa nor rank, so its calls write the same values
        if new:
            kf = lambda: tie_refine(skey, order, slots, ps, sa,  # noqa: E731
                                    rank, count)
            out = kf()
            sa_p, rank_p = sa.clone(), rank.clone()
            cnt_p = torch.zeros(1, dtype=torch.int32, device=device)
            want = tie_refine_plain(skey, order, slots, ps, sa_p, rank_p,
                                    cnt_p)
            m = int(cnt_p)
            if int(count) != m or any(
                    not torch.equal(a[:m], b[:m]) for a, b in zip(out, want)) \
                    or not torch.equal(sa, sa_p) \
                    or not torch.equal(rank, rank_p):
                raise AssertionError(f"round {rnd}: KF differs from its "
                                     "plain version")
            del sa_p, rank_p, want
            tail = kf
        else:
            kf = lambda: tie_refine(skey, order, slots, ps, sa,  # noqa: E731
                                    rank)
            p2, r2, still = kf()
            pos = torch.cumsum(still, 0)
            m = int(pos[-1])

            def tail():
                p2, r2, still = kf()
                pos = torch.cumsum(still, 0)
                both = torch.stack((pos[-1], bad[0].long()))
                dest = torch.where(still, pos - 1, m)
                out = []
                for x in (slots, p2, r2):
                    o = torch.empty(m + 1, dtype=x.dtype, device=x.device)
                    o.scatter_(0, dest, x)
                    out.append(o[:m])
                return out, both

        line = []

        def step(name, fn, nb=0, ops=0):
            ms = cs.cuda_ms(fn, REPS)
            a = alone_ms(cs, fn)
            sums[name] = sums.get(name, 0.0) + (ms if a is None else a)
            bnd = f", bound {cs.bound(nb, ops)[0]:.4f}" if nb else ""
            line.append(f"{name} {ms:.4f} ("
                        + ("waits" if a is None else f"alone {a:.4f}")
                        + f"{bnd})")

        step("KE", ke, 20 * n_t, 8 * n_t)
        step("sort", sort)
        # KF's bound (either package's): skey and order (8 + 8), slots
        # and the ps gather (4 + 4), the sa and rank stores (4 + 4) an
        # entry; 12 B a still-tied entry
        step("KF", kf, 32 * n_t + 12 * m, 20 * n_t)
        if not new:
            step("tail", tail, 32 * n_t + 12 * m, 20 * n_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        violated, n_still = flags.tolist() if new else \
            (int(bad[0]), m)
        read = (time.perf_counter() - t0) * 1e3
        sums["read"] = sums.get("read", 0.0) + read
        line.append(f"host read {read:.4f} (host clock)")
        if violated:
            raise AssertionError("a tie round read past the direct text")
        print(f"round {rnd} h={min(h, M)} tied {n_t} still {n_still}: "
              + "; ".join(line), flush=True)
        if n_still == 0:
            break
        if new:
            slots, ps, prims = (t[:n_still] for t in out)
        else:
            slots, ps, prims = tail()[0]
        del key, skey, order
        h = min(2 * h, 2 * M)
    print(f"tie rounds of {label}: {rnd}; sums over the rounds (alone where the step "
          f"does not wait; the reads on the host clock): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items()),
          flush=True)
    del sa, rank, tied
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose asgart_tpu_torch is measured")
    ap.add_argument("--mbp", type=float, default=128.0)
    ap.add_argument("--repeats-mbp", type=float, default=64.0)
    ap.add_argument("--parts", default="km,kj,kf",
                    help="what to measure, of km, kj and kf")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("km_kf_probe: CUDA is not available", file=sys.stderr)
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
    work = os.path.join(HERE, "build", "km_kf_probe")
    os.makedirs(work, exist_ok=True)
    n = int(args.mbp * 1e6)
    fa = os.path.join(work, "genome.fa")
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + synthetic_genome(
            n, np.random.default_rng(cs.SEED)).tobytes() + b"\n")
    rfa = os.path.join(work, "repeats.fa")
    if parts & {"km", "kf"}:
        with open(rfa, "wb") as fh:
            fh.write(b">chr1\n" + cs.repeat_genome(
                int(args.repeats_mbp * 1e6)).tobytes() + b"\n")
    if "km" in parts:
        km_probe(cs, fa, rfa, device)
    if "kj" in parts:
        kj_probe(cs, fa, device)
    if "kf" in parts:
        kf_probe(cs, "the whole k=20 -RC fused build",
                 fused_tie_state(fa, device), device)
        kf_probe(cs, "the k=20 -RC table build of table_repeats' genome",
                 table_tie_state(rfa, device), device)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
