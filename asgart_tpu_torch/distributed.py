"""The port's ranks on ``torch.distributed``: the mesh engines' collectives,
a rank worker and a multi-process dryrun.

A JAX mesh is one controller that owns D devices. The port's counterpart
is D processes, one per rank, each with one explicit device, joined by a
process group: the rank-sharded window engine
(``device_engine.ShardedWindowEngine``) keeps one shard of the window's
index on each rank and sums the ranks' partial results with
:func:`psum`; the table engine's probe-axis scan
(``device_engine.TableEngine``) scans each rank's own probe lanes and
shares the results with :func:`all_gather_var`; and the windows x probes
mesh engine (``device_engine.MeshWindowEngine``) gives each rank one
``--shards`` window and one probe slice, and shares every cell's result
the same way. Every rank ends with the same results, so each chains and
writes its own copy, as the JAX workers of asgart_tpu/distributed.py do;
a journal (``--checkpoint``) has one writer, rank 0.

Without a process group the world is one rank, :func:`psum` is the
identity and :func:`all_min` returns its argument: the meaning of a
one-device mesh. With a group (any size, one rank included) every call
is a real collective on the group's backend: NCCL for one rank per GPU,
gloo on the CPU and for ranks that share one GPU (NCCL refuses two ranks
on one device). ``stats`` records each collective's bytes and
milliseconds.

Run a worker (the port's CLI flags after ``--``)::

    python -m asgart_tpu_torch.distributed --rank R --world N --port P \\
        --device cpu -- genome.fa --trim 1000 65000 --min-length 800 \\
        --out out.json      # writes out.json.R and out.json.R.report

Run the dryrun: :func:`dryrun` (``dryrun(4, "cpu", fa, settings)``: four
gloo ranks on the CPU; ``dryrun(4, "cuda:0", fa, settings)``: four ranks
sharing one GPU, also on gloo; ``dryrun(4, "cpu", fa, settings,
shards=2)``: the windows x probes mesh of 2 windows x 2 ranks).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

TIMEOUT_S = 600  # of the group's set-up and of each of its collectives

stats: list = []  # (op, bytes, ms) of each collective of this process


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if initialized() else 0


def init(rank_: int, world_: int, device: torch.device,
         init_method: str, backend: str | None = None,
         timeout_s: float = TIMEOUT_S) -> None:
    """Join the default group as ``rank_`` of ``world_`` with ``device`` as
    this rank's device (made the current CUDA device); ``backend`` defaults
    to gloo on the CPU and NCCL on a GPU. Every collective of the group
    raises after ``timeout_s`` seconds instead of waiting for a rank that
    never comes. Returns once every rank has joined."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_,
                            timeout=datetime.timedelta(seconds=timeout_s))
    # one collective now makes the communicator (NCCL's buffers on the
    # card), so that free memory read afterwards is what a build may use
    dist.all_reduce(torch.zeros(1, device=_meta_device()))


def _meta_device() -> torch.device:
    """Where a collective of host values runs: the current GPU under
    NCCL (which takes no CPU tensor), the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _timed(op: str, nbytes: int, device: torch.device, run) -> None:
    t0 = time.perf_counter()
    run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.append((op, int(nbytes), (time.perf_counter() - t0) * 1e3))


def psum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (``all_reduce`` SUM), and
    returned; the identity without a group."""
    if initialized():
        _timed("all_reduce", t.numel() * t.element_size(), t.device,
               lambda: dist.all_reduce(t))
    return t


def all_min(x: float) -> float:
    """The least of every rank's ``x`` (``all_reduce`` MIN); ``x`` without
    a group."""
    if not initialized():
        return x
    t = torch.tensor([x], dtype=torch.float64, device=_meta_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return float(t.item())


def agree(x: float) -> bool:
    """Whether every rank passed the same ``x`` (exact in float64); True
    without a group. Every rank gets the same answer."""
    return all_min(x) == -all_min(-x)


def all_gather_var(t: torch.Tensor) -> list:
    """Every rank's 1-D tensor ``t`` (lengths may differ), in rank order,
    on ``t``'s device: the lengths first, then the tensors padded to the
    longest. ``[t]`` without a group."""
    if not initialized():
        return [t]
    D = dist.get_world_size()
    n = torch.tensor([t.numel()], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(n) for _ in range(D)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    n_max = max(sizes)
    padded = torch.zeros(n_max, dtype=t.dtype, device=t.device)
    padded[: t.numel()] = t
    outs = [torch.empty_like(padded) for _ in range(D)]
    _timed("all_gather", D * n_max * t.element_size(), t.device,
           lambda: dist.all_gather(outs, padded))
    return [o[:s] for o, s in zip(outs, sizes)]


# --- the rank worker and the dryrun --------------------------------------


def cli_args(fa: str, settings, out: str, shards: int = 1,
             checkpoint: str | None = None) -> list[str]:
    """The port's CLI flags for ``settings`` on the FASTA ``fa``, writing
    ``out``, with ``--shards`` and ``--checkpoint`` where given."""
    s = settings
    args = [fa, "--probe-size", str(s.probe_size),
            "--gap-size", str(s.max_gap_size - s.probe_size),
            "--min-length", str(s.min_duplication_length),
            "--max-cardinality", str(s.max_cardinality), "--out", out]
    if s.trim is not None:
        args += ["--trim", str(s.trim[0]), str(s.trim[1])]
    if shards > 1:
        args += ["--shards", str(shards)]
    if checkpoint is not None:
        args += ["--checkpoint", checkpoint]
    for flag, on in (("-R", s.reverse), ("-C", s.complement),
                     ("-S", s.skip_masked), ("--compute-score",
                                             s.compute_score)):
        if on:
            args.append(flag)
    if s.threads_count:
        args += ["--threads", str(s.threads_count)]
    return args


def rank_lanes(settings, chunks, r: int, D: int) -> int:
    """Probe lanes rank ``r`` of ``D`` scans in a probe-axis run over
    ``chunks``."""
    from .device_engine import chunk_specs, probe_lanes

    return sum(b - a for (_, _, nc) in chunk_specs(chunks, settings)
               for a, b in [probe_lanes(nc, r, D)])


def _worker(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="asgart_tpu_torch.distributed")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", required=True,
                    help="this rank's device, as cuda:0 or cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("cli", nargs=argparse.REMAINDER,
                    help="-- and the port's CLI flags")
    a = ap.parse_args(argv)
    from . import kernels
    from .cli.main import build_parser, settings_from_args
    from .exporters import JSONExporter
    from .pipeline import search_duplications

    cli = build_parser().parse_args(a.cli[1:] if a.cli[:1] == ["--"]
                                    else a.cli)
    settings = settings_from_args(cli)
    device = torch.device(a.device)
    t0 = time.time()
    init(a.rank, a.world, device, f"tcp://127.0.0.1:{a.port}", a.backend)
    report = {"rank": a.rank, "world": a.world, "device": str(device),
              "backend": dist.get_backend(), "init_s": time.time() - t0}
    try:
        kernels.reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        prof: dict = {}
        res = search_duplications(cli.strands, settings, engine="cuda",
                                  device=device, checkpoint=cli.checkpoint,
                                  shards=cli.shards, profile=prof)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            report["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        report.update(search_s=time.time() - t0, profile=prof,
                      launches=kernels.launch_counts(),
                      collectives=list(stats))
        if settings.trim is None and cli.shards == 1:
            from .fasta import prepare_data

            _, chunks, _ = prepare_data(cli.strands, settings.skip_masked,
                                        None)
            report["lanes"] = rank_lanes(settings, chunks, a.rank, a.world)
        with open(f"{cli.out}.{a.rank}", "w") as fh:
            JSONExporter().save(res, fh)
        with open(f"{cli.out}.{a.rank}.report", "w") as fh:
            json.dump(report, fh)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun(n_ranks: int, device: str, fa: str, settings,
           host: str | None = None, env: dict | None = None,
           timeout: float = 900.0, shards: int = 1,
           checkpoint: str | None = None) -> tuple[str, list]:
    """Spawn ``n_ranks`` worker processes, every one on ``device`` (the
    backend is gloo when several ranks share it, NCCL for one rank on a
    GPU), run the search of the FASTA ``fa`` with ``settings`` (and
    ``--shards``, ``--checkpoint``: the journal's path, one file for every
    rank) on each under the group, require the ranks' JSON to be identical
    and equal to the host engine's (``host``: its JSON text, computed here
    when None, with the same ``shards``). A trim window runs the
    rank-sharded window engine (``ASGART_RANK_SHARDED=1``, with the host
    build, ``ASGART_RSH_HOST_BUILD=1``, unless ``env`` says otherwise);
    ``env`` overlays the workers' environment. Every wait ends after
    ``timeout`` seconds: then every rank is killed and the dryrun raises.
    Returns the JSON text and each rank's report (its launches,
    collectives, peak device memory, walls and phase profile; a mesh
    rank's profile holds its cell under "mesh")."""
    import dataclasses
    import io

    from .exporters import JSONExporter
    from .pipeline import search_duplications

    # NCCL refuses two ranks on one GPU ("Duplicate GPU detected")
    backend = "nccl" if torch.device(device).type == "cuda" and \
        n_ranks == 1 else "gloo"
    with tempfile.TemporaryDirectory(prefix="asgart_dist_") as td:
        wenv = dict(os.environ)
        if settings.trim is not None:
            wenv.update(ASGART_RANK_SHARDED="1", ASGART_RSH_HOST_BUILD="1")
        wenv.update(env or {})
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        prev = wenv.get("PYTHONPATH", "")
        wenv["PYTHONPATH"] = pkg_root + (os.pathsep + prev if prev else "")
        out = os.path.join(td, "out.json")
        port = _free_port()
        procs, logs = [], []
        for r in range(n_ranks):
            log = open(os.path.join(td, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "asgart_tpu_torch.distributed",
                 "--rank", str(r), "--world", str(n_ranks), "--port",
                 str(port), "--device", device, "--backend", backend, "--",
                 *cli_args(fa, settings, out, shards, checkpoint)],
                env=wenv, cwd=pkg_root, stdout=log,
                stderr=subprocess.STDOUT))
        try:
            deadline = time.time() + timeout
            failed = []
            for r, p in enumerate(procs):
                rc = p.wait(timeout=max(1.0, deadline - time.time()))
                if rc != 0:
                    failed.append(r)
            if failed:
                raise RuntimeError("rank worker(s) failed:\n" + "\n".join(
                    f"rank {r} (rc={procs[r].returncode}):\n"
                    + _tail(logs[r]) for r in failed))
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f"rank workers did not finish in {timeout:.0f} s:\n"
                + "\n".join(f"rank {r}:\n{_tail(lg)}"
                            for r, lg in enumerate(logs)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
            for lg in logs:
                lg.close()
        texts, reports = [], []
        for r in range(n_ranks):
            with open(f"{out}.{r}") as fh:
                texts.append(fh.read())
            with open(f"{out}.{r}.report") as fh:
                reports.append(json.load(fh))
        if any(t != texts[0] for t in texts):
            raise AssertionError("the ranks' JSONs differ")
        if host is None:
            buf = io.StringIO()
            JSONExporter().save(search_duplications(
                [fa], dataclasses.replace(settings), engine="host",
                shards=shards), buf)
            host = buf.getvalue()
        if texts[0] != host:
            raise AssertionError(f"the ranks' JSON differs from the host "
                                 f"engine's ({len(texts[0])} vs "
                                 f"{len(host)} bytes)")
    return texts[0], reports


def _tail(log, n: int = 4000) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-n:]


if __name__ == "__main__":
    # run as the package's module, so that the engines' collectives record
    # into the same ``stats``
    from asgart_tpu_torch.distributed import _worker as worker

    worker(sys.argv[1:])
