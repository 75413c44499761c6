"""KN ``chain_bursts`` on one H100, apart from chip_smoke.py's paths.

    python3 scripts/kn_probe.py --capture [--mbp 128] [--repeats-mbp 64]
                                [--big-mbp 3100]
    python3 scripts/kn_probe.py [--root DIR] [--phases] [--reps 10]

``--capture`` runs four of chip_smoke's device-chain paths with this
checkout's package (``ASGART_DEVICE_CHAIN=1``): whole k = 20 (-RC, the
``--mbp`` synthetic genome, seed 1234), mj_shards (four windows on the
merge-join engine, reached by patching ``pipeline.fits``), table_repeats
(the ``--repeats-mbp`` repeat-dense genome, journaled) and big_whole (the
``--big-mbp`` genome, planner-routed). Each path's largest chunk's events
(by matches) are saved under ``build/kn_probe/``, with the host chain
(``native.chain_events``) on them: its families and its time (host clock).

Without ``--capture`` the saved events are chained with the package of
``--root`` (default: this checkout), so that two versions are timed in one
call on the same inputs: one KN pass at the capacities the chain ends
with, and the whole device chain (``chain.chain_rows``, its reruns and
host reads included), ``--reps`` calls each (CUDA events per call: mean,
min and max), with the families held to the host chain's. Also printed:
each chunk's bursts by length, and the longest burst's time per event.
``--phases`` builds the root's ``csrc/chain.cu`` again with ``-DKN_PHASES``
(a source that lacks those hooks, the earlier design of a block per
burst, gets them inserted at its phase boundaries), prints ptxas'
registers and spills, and prints, for the longest burst of each chunk and
the burst of most cycles, the SM cycles its block or warp spent by phase
(``PHASES``). Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(HERE, "build", "kn_probe")
CHUNKS = ("whole", "mj_shards", "table_repeats", "big_whole")
N_PHASES = 12  # csrc/chain.cu kPhases
# the cycle slots' names (None: a count), for csrc/chain.cu's own hooks
# and for those inserted into the block-per-burst source
PHASES = ("results", "spawns", "step end", "quiet", None, None, "loop top",
          "classification", "extensions")
BLOCK_PHASES = ("classification", "spawns", "aging, prune, emission", "quiet")

# the block-per-burst chain.cu: (anchor, text put after it) for its phase
# hooks
BLOCK_HOOKS = (
    ("#include \"common.cuh\"\n",
     "#define KN_PHASES_INSERTED 1\n"),
    ("    long long tests = 0;\n",
     "    KN_START();\n"),
    ("      if (e > e0) quiet_run(a, s, B, wsum, b, a.ev_z[e]);\n",
     "      KN_MARK(3);\n"),
    ("      match_step(a, s, B, wsum, mt, first, b, e, tests);\n",
     "      KN_MARK(2);\n"),
    ("      quiet_run(a, s, B, wsum, b, tz);\n",
     "      KN_MARK(3);\n"),
    ("    __syncthreads();\n    bool fresh = false;\n",
     "    KN_MARK(0);\n"),
    ("    spawned += tot;\n",
     "    KN_MARK(1);\n"),
    ("  __syncthreads();  // the spawned arms are written before they age\n",
     "  KN_MARK(1);\n"),
    ("    const int n = B.n;\n    if (n == 0) break;\n",
     "    KN_COUNT(4);\n"),
    ("  if (n > kPruneAbove) {\n    int out = 0;\n",
     "    KN_COUNT(5);\n"),
    ("      a.tests[b] = tsum;\n",
     "      KN_STORE(b);\n"),
)
BLOCK_MACROS = """
#ifdef KN_PHASES
__device__ long long* kn_phase_out;
__shared__ long long kn_acc[6];
__shared__ long long kn_t;
#define KN_START() if (threadIdx.x == 0) { for (int q = 0; q < 6; ++q) \\
    kn_acc[q] = 0; kn_t = clock64(); }
#define KN_MARK(k) if (threadIdx.x == 0) { long long t_ = clock64(); \\
    kn_acc[k] += t_ - kn_t; kn_t = t_; }
#define KN_COUNT(k) if (threadIdx.x == 0) kn_acc[k] += 1;
#define KN_STORE(b) for (int q = 0; q < 6; ++q) \\
    kn_phase_out[12 * (long long)(b) + q] = kn_acc[q];
ASGART_API int asgart_chain_phases(void* p) {
  return (int)cudaMemcpyToSymbol(kn_phase_out, &p, sizeof(p));
}
#endif
"""


def smoke():
    """This checkout's chip_smoke.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def times_ms(fn, reps: int) -> list:
    """Milliseconds of each of ``reps`` calls of ``fn`` (CUDA events
    around each, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def spread(ts: list) -> str:
    return (f"{sum(ts) / len(ts):.4f} (min {min(ts):.4f}, max "
            f"{max(ts):.4f}, {len(ts)} calls)")


# --- capture ---------------------------------------------------------------

def chain_spy(run):
    """``run()`` with ``ASGART_DEVICE_CHAIN=1``; returns the largest
    chunk's (Events, ChainConfig) by matches."""
    from asgart_tpu_torch import device_engine

    chain = device_engine.chain_events_tensors
    seen = []

    def spy(ev, cfg, *a, **kw):
        out = chain(ev, cfg, *a, **kw)
        if not seen or out[1].matches > seen[0][2]:
            seen[:] = [(ev, cfg, out[1].matches)]
        return out

    device_engine.chain_events_tensors = spy
    os.environ["ASGART_DEVICE_CHAIN"] = "1"
    try:
        run()
    finally:
        del os.environ["ASGART_DEVICE_CHAIN"]
        device_engine.chain_events_tensors = chain
    return seen[0][:2]


def save_chunk(name, ev, cfg):
    """The chunk's events and settings, with the host chain's families and
    time on them, under WORK/<name>.pt."""
    import numpy as np
    import torch

    from asgart_tpu_torch import native

    ev_i, ev_z, m_off, m = (x.cpu().numpy()
                            for x in (ev.ev_i, ev.ev_z, ev.m_off, ev.m))
    m64 = m.astype(np.int64) + ev.m_offset
    t0 = time.time()
    fams = native.chain_events(
        ev_i, ev_z, m_off, m64, z_trail=int(ev.z_trail),
        probe_size=cfg.probe_size, step_size=cfg.step_size,
        max_gap_size=cfg.max_gap_size,
        min_duplication_length=cfg.min_duplication_length,
        max_cardinality=cfg.max_cardinality)
    host_ms = (time.time() - t0) * 1e3
    torch.save({"ev_i": ev.ev_i.cpu(), "ev_z": ev.ev_z.cpu(),
                "m_off": ev.m_off.cpu(), "m": ev.m.cpu(),
                "z_trail": ev.z_trail.cpu(), "m_offset": ev.m_offset,
                "cfg": dict(cfg._asdict())}, os.path.join(WORK, name + ".pt"))
    with open(os.path.join(WORK, name + ".host.pkl"), "wb") as fh:
        pickle.dump({"families": fams, "host_ms": host_ms}, fh)
    print(f"{name}: {len(ev_i)} events, {len(m)} matches, m_offset "
          f"{ev.m_offset}; host chain {host_ms:.3f} ms, {len(fams)} "
          f"families", flush=True)


def capture(cs, args, device):
    import numpy as np
    import torch

    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.synthetic import synthetic_genome

    s = RunSettings(probe_size=20, reverse=True, complement=True)
    n = int(args.mbp * 1e6)
    fa = os.path.join(WORK, "genome.fa")
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + synthetic_genome(
            n, np.random.default_rng(cs.SEED)).tobytes() + b"\n")

    def fresh():
        INDEX_CACHE.clear()
        torch.cuda.empty_cache()

    def run(name, fn):
        fresh()
        t0 = time.time()
        ev, cfg = chain_spy(fn)
        print(f"{name}: device-chain run {time.time() - t0:.1f} s",
              flush=True)
        save_chunk(name, ev, cfg)
        fresh()

    want = set(args.chunks.split(","))
    if "whole" in want:
        run("whole", lambda: search_duplications([fa], s, engine="cuda",
                                                 device=device))
    fits = pipeline.fits
    pipeline.fits = lambda *a, **kw: False  # the merge-join window engine
    try:
        if "mj_shards" in want:
            run("mj_shards", lambda: search_duplications(
                [fa], s, engine="cuda", device=device, shards=cs.SHARDS))
    finally:
        pipeline.fits = fits
    nr = int(args.repeats_mbp * 1e6) if "table_repeats" in want else 0
    if nr:
        rfa = os.path.join(WORK, "repeats.fa")
        with open(rfa, "wb") as fh:
            fh.write(b">chr1\n" + cs.repeat_genome(nr).tobytes() + b"\n")
        journal = os.path.join(WORK, "repeats.journal")
        if os.path.exists(journal):
            os.remove(journal)
        run("table_repeats", lambda: search_duplications(
            [rfa], s, engine="cuda", device=device, checkpoint=journal))
    if args.big_mbp and "big_whole" in want:
        bfa = os.path.join(WORK, "big.fa")
        cs.big_genome(bfa, args.big_mbp)
        run("big_whole", lambda: search_duplications(
            [bfa], s, engine="cuda", device=device))
        os.remove(bfa)


# --- phases ----------------------------------------------------------------

def phases_lib(root: str):
    """The root's chain.cu built with -DKN_PHASES into its own library
    (hooks inserted where the source has none)."""
    from asgart_tpu_torch.kernels import _build

    src = open(os.path.join(root, "asgart_tpu_torch", "csrc",
                            "chain.cu")).read()
    inserted = "KN_PHASES" not in src
    if inserted:
        for anchor, text in BLOCK_HOOKS:
            if src.count(anchor) != 1:
                raise RuntimeError(f"kn_probe: hook anchor {anchor!r} "
                                   "not found once")
            src = src.replace(anchor, anchor + text)
        src = src.replace("namespace {\n", BLOCK_MACROS + "namespace {\n", 1)
    d = os.path.join(WORK, "phases_" + str(abs(hash(root))))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "chain.cu"), "w") as fh:
        fh.write(src)
    with open(os.path.join(root, "asgart_tpu_torch", "csrc",
                           "common.cuh")) as fh:
        common = fh.read()
    with open(os.path.join(d, "common.cuh"), "w") as fh:
        fh.write(common)
    so = os.path.join(d, "libkn_phases.so")
    nvcc = _build._nvcc()
    res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-DKN_PHASES", "-shared",
                          "-Xptxas", "-v", "-o", so,
                          os.path.join(d, "chain.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("kn_probe: phases build failed:\n"
                           + res.stderr[-4000:])
    # registers, stack frame and spills of the kernels (ptxas)
    info = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "ptxas info" in ln and ("Used" in ln or "stack" in ln)
            or "spill" in ln]
    print("kn_probe: ptxas (-DKN_PHASES): " + " | ".join(info), flush=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("asgart_chain") and hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.asgart_chain_phases.argtypes = [ctypes.c_void_p]
    lib.asgart_chain_phases.restype = ctypes.c_int
    return lib, BLOCK_PHASES if inserted else PHASES


class _Both:
    """The package's library with its chain entries taken from another."""

    def __init__(self, main, chain):
        self._main, self._chain = main, chain

    def __getattr__(self, name):
        if name.startswith("asgart_chain") and hasattr(self._chain, name):
            return getattr(self._chain, name)
        return getattr(self._main, name)


# --- timing ----------------------------------------------------------------

def load_chunk(name, device):
    import torch

    from asgart_tpu_torch.chain import ChainConfig, Events

    d = torch.load(os.path.join(WORK, name + ".pt"))
    ev = Events(*(d[k].to(device) for k in ("ev_i", "ev_z", "m_off", "m",
                                            "z_trail")), d["m_offset"])
    with open(os.path.join(WORK, name + ".host.pkl"), "rb") as fh:
        host = pickle.load(fh)
    return ev, ChainConfig(**d["cfg"]), host


def time_chunk(cs, name, device, reps, phases):
    import numpy as np
    import torch

    from asgart_tpu_torch.chain import (burst_threshold, bursts_from_events,
                                        chain_rows, families_from_rows)
    from asgart_tpu_torch.kernels import _build
    from asgart_tpu_torch.kernels import chain as kc

    ev, cfg, host = load_chunk(name, device)
    rows, st = chain_rows(ev, cfg)
    if families_from_rows(rows.cpu().numpy()) != host["families"]:
        raise AssertionError(f"{name}: KN's families differ from the host "
                             "chain's")
    t = burst_threshold(cfg)
    bs, order = bursts_from_events(ev, t)
    lens = (bs[1:] - bs[:-1]).cpu().numpy()
    hist = np.bincount(np.ceil(np.log2(np.maximum(lens, 1))).astype(int))
    per_ev = (ev.m_off[1:] - ev.m_off[:-1]).cpu().numpy()
    lo = int(bs[int(order[0])])
    lm = per_ev[lo: lo + int(lens.max())]

    def one_pass():
        return kc.chain_bursts(
            ev.ev_i, ev.ev_z, ev.m_off, ev.m, ev.m_offset, bs, order,
            ev.z_trail, t, cfg.probe_size, cfg.step_size, cfg.max_gap_size,
            cfg.min_duplication_length, st.arms, max(st.rows, 1))

    r = min(reps, 3) if st.events > 10 ** 6 else reps
    kn = times_ms(one_pass, r)
    whole = times_ms(lambda: chain_rows(ev, cfg), r)
    bnd, _ = cs.bound(st.events * 16 + st.matches * ev.m.element_size()
                      + st.rows * 48, st.tests)
    mean = sum(kn) / len(kn)
    print(f"{name}: {st.events} events, {st.matches} matches, {st.bursts} "
          f"bursts (by length, ceil log2: {hist.tolist()}), the longest "
          f"{st.longest} events with {int(lm.sum())} matches (max "
          f"{int(lm.max())} an event), {st.tests} native tests, {st.rows} "
          f"rows, {st.arms} arms, {st.passes} passes", flush=True)
    print(f"{name}: one KN pass {spread(kn)} ms, bound {bnd:.6f} ms; "
          f"{mean * 1e3 / st.longest:.4f} us an event of the longest "
          f"burst; the device chain {spread(whole)} ms; the host chain "
          f"{host['host_ms']:.3f} ms (capture)", flush=True)
    if not phases:
        return
    lib = _build.lib()
    plib, names = phases_lib(phases)
    inserted = names is BLOCK_PHASES
    nb = bs.numel() - 1
    out = torch.zeros((nb, N_PHASES), dtype=torch.int64, device=device)
    _build.check(plib.asgart_chain_phases(out.data_ptr()), "phases")
    _build._lib = _Both(lib, plib)
    try:
        one_pass()
        torch.cuda.synchronize()
    finally:
        _build._lib = lib
    timed = [q for q, p in enumerate(names) if p]
    slowest = int(out[:, timed].sum(1).argmax())
    for what, b in (("the longest burst", int(order[0])),
                    ("the burst of most cycles", slowest)):
        c = out[b].tolist()
        n_ev = int(lens[b])
        cyc = sum(c[q] for q in timed)
        print(f"{name} phases of {what} ({n_ev} events; SM cycles, share): "
              + ", ".join(f"{names[q]} {c[q]} ({c[q] / max(cyc, 1):.3f})"
                          for q in timed)
              + f"; {cyc / n_ev:.0f} cycles an event; "
              + (f"{c[4]} quiet steps run, {c[5]} prunes" if inserted else
                 f"{c[4]} quiet runs that did work, {c[5]} compactions; "
                 f"arms at the snapshot {c[9] / n_ev:.1f} and matches "
                 f"{c[10] / n_ev:.1f} an event"), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capture", action="store_true",
                    help="run the paths and save their largest chunks")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose asgart_tpu_torch is measured")
    ap.add_argument("--mbp", type=float, default=128.0)
    ap.add_argument("--repeats-mbp", type=float, default=64.0)
    ap.add_argument("--big-mbp", type=float, default=3100.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--phases", action="store_true",
                    help="also split the longest bursts' cycles by phase")
    ap.add_argument("--chunks", default=",".join(CHUNKS),
                    help="the chunks to capture or to time")
    ap.add_argument("--threads", type=int, default=0,
                    help="the block path's threads (a package with a warp "
                    "path; default: its THREADS)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kn_probe: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(HERE if args.capture else args.root)
    sys.path.insert(0, root)
    cs = smoke()
    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.kernels import _build

    print(cs.smi_line())
    print(f"measured package: {root}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    _build.lib()
    print(f"kernel library built and loaded in {time.time() - t0:.1f} s",
          flush=True)
    device = cuda_device()
    os.makedirs(WORK, exist_ok=True)
    from asgart_tpu_torch.kernels import chain as kc

    if args.threads and hasattr(kc, "WARP_ARMS"):
        kc.THREADS = args.threads
    print(f"KN: {kc.THREADS} threads a block"
          + (f", a warp per burst up to {kc.WARP_ARMS} arms"
             if hasattr(kc, "WARP_ARMS") else ", a block per burst"),
          flush=True)
    if args.capture:
        capture(cs, args, device)
    else:
        for name in args.chunks.split(","):
            if os.path.exists(os.path.join(WORK, name + ".pt")):
                time_chunk(cs, name, device, args.reps,
                           root if args.phases else None)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
