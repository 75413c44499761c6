"""KE ``tie_keys`` with the round's sort, KF ``tie_refine``, and KO
``granule_totals`` on one H100, apart from chip_smoke.py's paths.

    python3 scripts/ke_ko_probe.py [--root DIR] [--mbp 128]
                                   [--repeats-mbp 64] [--parts ke,ko]
                                   [--builds whole,mj_trim,table,table_repeats]

``--root`` is the checkout whose ``asgart_tpu_torch`` is measured (default:
this one), so that two versions are compared in one call; the helpers
(``cuda_ms``, ``kernel_ms``, ``bound``, ``smi_line``, ``repeat_genome``)
come from this checkout's chip_smoke.py. Every time is a 20-call mean
(CUDA events) of the launches alone behind a busy-wait on the card
(``kernel_ms``); the host read is on the host clock.

KE: the tie rounds of four builds (-RC, the ``--mbp`` synthetic genome,
seed 1234, unless marked): the whole genome's fused build at k = 20, the
merge-join build of chip_smoke's middle trim window (3n/8..5n/8, 32 M rows
at 128 Mbp) at k = 20, the table build at k = 20 (``table``) and the
table build of the ``--repeats-mbp`` repeat-dense genome (``table_repeats``,
its subset rounds after its full rounds). Each build's state before its
tie resolution is captured by wrapping ``resolve_ties`` in the build's
module; the rounds then run as ``ties.resolve_ties`` runs them, each step
timed on that round's state before the round advances. Per round: the
tied entries, the groups (runs of equal ``prims``), the largest, the
count of groups of 2, 3-32, 33-1,024, 1,025-16,384 entries and larger
(and of 1, which must be 0); then for a package whose KE returns the keys
(the parent): KE alone, ``torch.sort(stable=True)`` of its keys, KF; for
one whose KE sorts each group itself (``TIE_SORT_CAP``): KE's sizing pass
and its read before the loop where the tied set reaches
``ties.SIZING_MIN``, then per round KE as the round routes it (with the
round's sort), the library route (KE's key pass and ``torch.sort``) on
the same round, KE's own sort wherever the round's largest group fits,
held exactly to the library route, and KF; the round's host read. Sums
over each build's rounds close each build, and for the latter package
the build's net change against the library route in every round (the
parent's route): the rounds as routed and the sizing pass on the card,
the read before the loop on the host clock.

KO on the lanes of table_repeats' one chunk (KM's lanes of the table
engine) and of whole_sliced's largest chunk (the fused index's lane views
of that chunk): the kernel alone, the wrapper, the plain version, the
bound (9 B a lane and 8 B a granule) and a contiguous floor of the same
9 B a lane (``copy_`` of lane_lo, lane_hi and lane_mask, which also writes
them). Prints one line per measurement, the card first. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
SIZES = ((1, 1), (2, 2), (3, 32), (33, 1024), (1025, 16384),
         (16385, 1 << 62))


def smoke():
    """This checkout's chip_smoke.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sorting_ke() -> int | None:
    """The measured package's KE capacity (its largest group sorted by the
    kernel), or None where KE returns the keys (the parent)."""
    from asgart_tpu_torch.kernels import ties

    return getattr(ties, "TIE_SORT_CAP", None)


def captured(build):
    """(``build()``'s result, the arguments of the ``resolve_ties`` call it
    made: (sa, rank, tied, M, k, kwargs), cloned before the call)."""
    from asgart_tpu_torch import fused_index, table_index, window_index

    mods = (fused_index, window_index, table_index)
    real = [m.resolve_ties for m in mods]
    got = []

    def capture(sa, rank, tied, M, k, **kw):
        got.append((sa.clone(), rank.clone(), tied.clone(), M, k, kw))
        return real[0](sa, rank, tied, M, k, **kw)

    for m in mods:
        m.resolve_ties = capture
    try:
        out = build()
    finally:
        for m, f in zip(mods, real):
            m.resolve_ties = f
    (state,) = got
    return out, state


def group_stats(prims):
    """(groups, largest, counts by SIZES) of one round's entries."""
    import torch

    n = prims.numel()
    start = torch.ones(n, dtype=torch.bool, device=prims.device)
    start[1:] = prims[1:] != prims[:-1]
    at = torch.nonzero(start).flatten()
    size = torch.diff(at, append=torch.tensor([n], device=at.device))
    counts = [int(((size >= a) & (size <= b)).sum()) for a, b in SIZES]
    return at.numel(), int(size.max()), counts


def tie_rounds(cs, label, state, device):
    """``ties.resolve_ties``' subset rounds from ``state`` (sa, rank, tied,
    M, k, kwargs: a table build's ``tied_cap`` and ``direct_bound`` run its
    full rounds first), each round's steps timed before it advances."""
    import torch

    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.kernels import tie_keys, tie_refine
    from asgart_tpu_torch.ties import full_rounds

    sa, rank, tied, M, k, kw = state
    del state
    h = k
    if kw.get("tied_cap") is not None:
        sa, tied, h = full_rounds(sa, rank, tied, k, kw["tied_cap"],
                                  kw["direct_bound"])
        rank = rank[:kw["direct_bound"]]
    slots = torch.nonzero(tied).flatten()
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(torch.int32)
    cap = sorting_ke()
    flags = torch.zeros(2 if cap is None else 3, dtype=torch.int32,
                        device=device)
    bad, count = flags[:1], flags[1:]
    print(f"tie rounds of {label} (M={M}, {slots.numel()} tied entries at "
          f"h={h}; KE "
          f"{'returns keys' if cap is None else f'sorts groups up to {cap}'})",
          flush=True)
    rnd, sums, largest = 0, {}, None

    def alone(name, fn):
        ms = cs.kernel_ms(fn, REPS)
        sums[name] = sums.get(name, 0.0) + ms
        return ms

    # KE's sizing pass and the read before the loop, where the package
    # sizes this tied set (ties.SIZING_MIN; every set where it has none)
    sizing_min = getattr(ties_mod, "SIZING_MIN", 0)
    pre = {}
    if cap is not None and slots.numel() >= sizing_min:
        from asgart_tpu_torch.kernels import tie_groups

        t_g = alone("sizing pass", lambda: tie_groups(prims, flags[2:]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (largest,) = flags[2:].tolist()
        read = (time.perf_counter() - t0) * 1e3
        sums["read"] = read
        pre = {"sizing pass": t_g, "its read": read}
        print(f"{label} sizing pass {t_g:.4f} ms alone: largest group "
              f"{largest}; its host read {read:.4f} (host clock)",
              flush=True)
    elif cap is not None:
        print(f"{label}: no sizing pass ({slots.numel()} tied entries, "
              f"under ties.SIZING_MIN {sizing_min}): the first round on "
              "the library route", flush=True)

    while h < 2 * M:
        rnd += 1
        hh = min(h, M)
        n_t = ps.numel()
        groups, big, counts = group_stats(prims)
        sizes = ", ".join(f"{a}-{b if b < 1 << 62 else 'up'}: {c}"
                          for (a, b), c in zip(SIZES, counts))
        line = [f"groups {groups}, largest {big} ({sizes})"]
        if cap is None:
            ke = lambda: tie_keys(ps, prims, rank, hh, bad)  # noqa: E731
            key = ke()
            sort = lambda: torch.sort(key, stable=True)  # noqa: E731
            skey, order = sort()
            t_ke, t_sort = alone("KE", ke), alone("sort", sort)
            line.append(f"KE {t_ke:.4f}, sort {t_sort:.4f}, KE + sort "
                        f"{t_ke + t_sort:.4f}")
            sums["KE + sort"] = sums.get("KE + sort", 0.0) + t_ke + t_sort
            del key
        else:
            routed = "kernel" if largest is not None and largest <= cap \
                else "library"
            lib = lambda: tie_keys(ps, prims, rank, hh, bad)  # noqa: E731
            want = lib()
            t_lib = cs.kernel_ms(lib, REPS)
            sums["library route"] = sums.get("library route", 0.0) + t_lib
            own = ""
            t_own = None
            if big > cap:  # the kernel on the groups within its capacity
                start = torch.ones(n_t, dtype=torch.bool, device=device)
                start[1:] = prims[1:] != prims[:-1]
                at = torch.nonzero(start).flatten()
                size = torch.diff(at, append=at.new_tensor([n_t]))
                keep = (size <= cap)[torch.cumsum(start, 0) - 1]
                kps, kprims = ps[keep], prims[keep]
                if kps.numel():
                    g = int(size[size <= cap].max())
                    sub = lambda: tie_keys(kps, kprims, rank, hh,  # noqa
                                           bad, g)
                    sub_lib = lambda: tie_keys(kps, kprims, rank,  # noqa
                                               hh, bad)
                    if any(not torch.equal(a, b) for a, b in
                           zip(sub(), sub_lib())):
                        raise AssertionError(f"{label} round {rnd}: KE's "
                                             "sort differs on the groups "
                                             "within its capacity")
                    own = (f", on the {kps.numel()} entries of its groups "
                           f"within the capacity: KE sorting "
                           f"{cs.kernel_ms(sub, REPS):.4f}, library route "
                           f"{cs.kernel_ms(sub_lib, REPS):.4f}")
                del kps, kprims
            if big <= cap:
                mine = lambda: tie_keys(ps, prims, rank, hh,  # noqa: E731
                                        bad, big)
                got = mine()
                if any(not torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{label} round {rnd}: KE's sort "
                                         "differs from the library route")
                del got
                t_own = cs.kernel_ms(mine, REPS)
                sums["KE sorting"] = sums.get("KE sorting", 0.0) + t_own
                own = f", KE sorting (held to it: equal) {t_own:.4f}"
            t_rt = t_own if routed == "kernel" else t_lib
            sums["as routed"] = sums.get("as routed", 0.0) + t_rt
            line.append(f"route {routed} {t_rt:.4f}; library route (KE key "
                        f"pass + sort) {t_lib:.4f}{own}")
            skey, order = want
        # KF reads neither sa nor rank: its repeated calls write the same
        kf = lambda: tie_refine(skey, order, slots, ps, sa,  # noqa: E731
                                rank, count)
        out = kf()
        line.append(f"KF {alone('KF', kf):.4f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = flags.tolist()
        read = (time.perf_counter() - t0) * 1e3
        sums["read"] = sums.get("read", 0.0) + read
        line.append(f"host read {read:.4f} (host clock)")
        violated, n_still = got[:2]
        if cap is not None:
            largest = got[2]
        if violated:
            raise AssertionError("a tie round read past the direct text")
        print(f"{label} round {rnd} h={hh} tied {n_t} still {n_still}: "
              + "; ".join(line), flush=True)
        if n_still == 0:
            break
        slots, ps, prims = (t[:n_still] for t in out)
        del skey, order
        h = min(2 * h, 2 * M)
    print(f"{label}: {rnd} rounds; sums over the rounds (ms; the reads on "
          "the host clock): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in sums.items()),
          flush=True)
    if cap is not None:  # the build's net change against the parent's route
        dev = sums["as routed"] + pre.get("sizing pass", 0.0) \
            - sums["library route"]
        print(f"{label}: net change of the build against the library route "
              f"in every round: {dev:+.4f} ms on the card (as routed + the "
              f"sizing pass - the library route) and "
              f"{pre.get('its read', 0.0):+.4f} ms of host read before the "
              "loop (host clock)", flush=True)
    del sa, rank, tied
    torch.cuda.empty_cache()


def group_sizes(cs, device):
    """KE's sort alone on one round of a single group of s entries (in
    registers, up to the capacity), secs drawn at random from the rank
    plane or all equal, beside the library route on the same round."""
    import numpy as np
    import torch

    from asgart_tpu_torch.kernels import tie_keys
    from asgart_tpu_torch.kernels.ties import TIE_SORT_CAP

    rng = np.random.default_rng(cs.SEED)
    for s in sorted({32, 64, TIE_SORT_CAP}):
        for kind in ("random", "equal"):
            W = 1 << 27
            ps = torch.from_numpy(rng.choice(W - 64, s, replace=False)
                                  .astype(np.int32)).to(device)
            prims = torch.full((s,), 5, dtype=torch.int32, device=device)
            rank = torch.from_numpy(
                rng.integers(0, W, W).astype(np.int32) if kind == "random"
                else np.full(W, 5, np.int32)).to(device)
            bad = torch.zeros(1, dtype=torch.int32, device=device)
            mine = lambda: tie_keys(ps, prims, rank, 3, bad, s)  # noqa
            lib = lambda: tie_keys(ps, prims, rank, 3, bad)  # noqa
            if any(not torch.equal(a, b) for a, b in zip(mine(), lib())):
                raise AssertionError(f"group of {s}: KE's sort differs")
            print(f"one group of {s} entries, {kind} secs: KE's sort alone "
                  f"{cs.kernel_ms(mine, REPS):.4f} ms, library route "
                  f"{cs.kernel_ms(lib, REPS):.4f}", flush=True)
            del rank
    torch.cuda.empty_cache()


def ko_case(cs, tag, lo, hi, mask):
    import torch

    from asgart_tpu_torch.host_helpers import SLICE_GRAN
    from asgart_tpu_torch.kernels import granule_totals
    from asgart_tpu_torch.kernels.slices import granule_totals_plain

    n = lo.numel()
    ko = lambda: granule_totals(lo, hi, mask, SLICE_GRAN)  # noqa: E731
    po = lambda: granule_totals_plain(lo, hi, mask, SLICE_GRAN)  # noqa: E731
    gt = ko()
    if not torch.equal(gt, po()):
        raise AssertionError(f"{tag}: KO differs from its plain version")
    c_lo, c_hi, c_mask = (torch.empty_like(t) for t in (lo, hi, mask))

    def floor():  # the same 9 B a lane, read in order (and written)
        c_lo.copy_(lo)
        c_hi.copy_(hi)
        c_mask.copy_(mask)

    b = cs.bound(9 * n + 8 * gt.numel(), 2 * n)
    align = ", ".join(f"{name} at {t.data_ptr() % 16} mod 16" for name, t in
                      (("lane_lo", lo), ("lane_hi", hi), ("lane_mask", mask)))
    print(f"KO granule_totals {tag} ({n} lanes, {gt.numel()} granules of "
          f"{SLICE_GRAN}; {align}): alone {cs.kernel_ms(ko, REPS):.4f} ms, "
          f"wrapper {cs.cuda_ms(ko, REPS):.4f}, plain "
          f"{cs.cuda_ms(po, REPS):.4f}"
          f", bound {b[0]:.4f} ({b[1]}); contiguous floor (copy_ of the 9 B "
          f"a lane) alone {cs.kernel_ms(floor, REPS):.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose asgart_tpu_torch is measured")
    ap.add_argument("--mbp", type=float, default=128.0)
    ap.add_argument("--repeats-mbp", type=float, default=64.0)
    ap.add_argument("--parts", default="ke,ko",
                    help="what to measure, of ke, ko and groups (KE's sort "
                    "on single groups of several sizes)")
    ap.add_argument("--builds", default="whole,mj_trim,table,table_repeats",
                    help="the builds whose tie rounds are measured")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    builds = args.builds.split(",")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ke_ko_probe: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = smoke()
    from asgart_tpu_torch import device_engine as de
    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.kernels import _build, table_ranges
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.synthetic import synthetic_genome
    from asgart_tpu_torch.table_index import DeviceIndex
    from asgart_tpu_torch.window_index import DeviceWindowIndex

    print(cs.smi_line())
    print(f"measured package: {root}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    _build.lib()
    print(f"kernel library built and loaded in {time.time() - t0:.1f} s",
          flush=True)
    device = cuda_device()
    work = os.path.join(HERE, "build", "ke_ko_probe")
    os.makedirs(work, exist_ok=True)
    n = int(args.mbp * 1e6)
    fa = os.path.join(work, "genome.fa")
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + synthetic_genome(
            n, np.random.default_rng(cs.SEED)).tobytes() + b"\n")
    rfa = os.path.join(work, "repeats.fa")
    with open(rfa, "wb") as fh:
        fh.write(b">chr1\n" + cs.repeat_genome(
            int(args.repeats_mbp * 1e6)).tobytes() + b"\n")
    if "groups" in parts and sorting_ke() is not None:
        group_sizes(cs, device)
    k = 20
    s = RunSettings(probe_size=k, reverse=True, complement=True)
    _, chunks, strand = prepare_data([fa], s.skip_masked, None)
    for b in builds:
        if b == "whole":
            eng = de.FusedEngine(strand, s, device, cache=None)
            idx, state = captured(lambda: eng.ensure_index(chunks))
            if "ko" in parts:
                (_, _, nc), (off, _) = max(
                    ((sp, idx.offs[sp[:2]]) for sp in idx.specs),
                    key=lambda x: x[1][1])
                ko_case(cs, "whole_sliced's largest chunk (lane views)",
                        *(t[off: off + nc] for t in
                          (idx.lane_lo, idx.lane_hi, idx.lane_mask)))
            del idx, eng
            label = "the whole k=20 -RC fused build"
        elif b == "mj_trim":
            trim = (3 * n // 8, 5 * n // 8)
            _, state = captured(lambda: DeviceWindowIndex.build(
                strand.data, k, trim, True, True, device))
            label = f"the k=20 merge-join build of window {trim}"
        elif b in ("table", "table_repeats"):
            src = fa if b == "table" else rfa
            _, tchunks, tstrand = prepare_data([src], s.skip_masked, None)
            idx, state = captured(lambda: DeviceIndex.build(
                tstrand.data, k, True, True, device))
            if b == "table_repeats" and "ko" in parts:
                specs = de.chunk_specs(tchunks, s)
                lo, hi, mask, _, lane_off = table_ranges(
                    idx.pos_lo, idx.pos_hi, specs, len(tstrand.data), k,
                    True, True)
                (_, _, nc), off = max(zip(specs, lane_off),
                                      key=lambda x: x[0][2])
                ko_case(cs, "table_repeats' chunk (KM's lanes)",
                        *(t[off: off + nc] for t in (lo, hi, mask)))
                del lo, hi, mask
            del idx
            label = f"the k=20 -RC table build ({b})"
        else:
            raise ValueError(f"unknown build {b}")
        torch.cuda.empty_cache()
        if "ke" in parts:
            tie_rounds(cs, label, state, device)
        del state
        torch.cuda.empty_cache()
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
