"""Multi-host window driver: one ``--trim`` window per PROCESS.

The reference's documented scale-out is manual: run ``asgart --trim a b``
per memory-bounded window, then merge the partial JSONs with
``asgart-slice`` (the reference's ``src/structs.rs:114-141`` +
README v2.0 notes). ``--shards N`` automates that in-process; this module
automates it ACROSS processes — the multi-host (DCN) execution form.
Windows need **zero cross-process communication** (families never span
windows, per reference trim semantics), so the "collective" is just the
window-ordered concatenation of partial results, performed once at the
end by the driver. On a pod deployment each worker command runs on its
own host against its own chips (the driver's subprocess list IS the
per-host command list — dispatch it via your scheduler of choice);
in-image it runs the workers as local subprocesses, which exercises the
identical code path end to end.

Output is byte-equal to the in-process ``--shards N`` run and to the
sequential trim+merge workflow (pinned by tests/test_multihost.py).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import sys
import tempfile
from typing import Optional

from .structs import RunResult, RunSettings

log = logging.getLogger("asgart")


def plan_windows(total_len: int, shards: int) -> list[tuple[int, int]]:
    """Equal trim windows covering [0, total_len) — the same split as
    the in-process ``--shards`` path (pipeline
    ._search_duplications_sharded)."""
    per = (total_len + shards - 1) // shards
    windows = [(w * per, min(total_len, (w + 1) * per))
               for w in range(shards)]
    return [w for w in windows if w[0] < w[1]]


def window_argv(strands_files: list[str], settings: RunSettings,
                window: tuple[int, int], out_path: str,
                engine: str = "host") -> list[str]:
    """The worker command for one window: a plain ``asgart`` CLI
    invocation (runnable locally, via ssh, or under a cluster
    scheduler)."""
    argv = [sys.executable, "-m", "asgart_tpu_torch.cli.main",
            *strands_files,
            "--trim", str(window[0]), str(window[1]),
            "--probe-size", str(settings.probe_size),
            "--gap-size",
            str(settings.max_gap_size - settings.probe_size),
            "--min-length", str(settings.min_duplication_length),
            "--max-cardinality", str(settings.max_cardinality),
            "--engine", engine,
            "--out", out_path]
    if settings.reverse:
        argv.append("-R")
    if settings.complement:
        argv.append("-C")
    if settings.skip_masked:
        argv.append("-S")
    if settings.compute_score:
        argv.append("--compute-score")
    if settings.threads_count:
        argv += ["--threads", str(settings.threads_count)]
    return argv


def merge_partials(part_files: list[str],
                   settings: RunSettings) -> RunResult:
    """Window-ordered merge of partial results — the reference's
    ``asgart-slice`` concat (``RunResult.from_files``), with the run's
    own (untrimmed) settings stamped, exactly like the in-process
    ``--shards`` merge."""
    merged = RunResult.from_files(part_files)
    merged.settings = dataclasses.replace(settings, trim=None)
    return merged


def search_duplications_multihost(
    strands_files: list[str],
    settings: RunSettings,
    shards: int,
    hosts: int,
    engine: str = "host",
    workdir: Optional[str] = None,
    env: Optional[dict] = None,
) -> RunResult:
    """Run ``shards`` trim windows as worker PROCESSES, at most
    ``hosts`` concurrently (one per host in a real deployment), and
    merge their partial JSONs.

    ``env`` entries overlay ``os.environ`` for the workers (tests pin
    ``JAX_PLATFORMS=cpu``; a pod launcher would set per-host visible
    devices instead)."""
    if settings.trim is not None:
        raise ValueError("multi-host runs cannot be combined with --trim")
    from .fasta import prepare_data

    # parse once to learn the strand length (window planning only; the
    # workers re-read the inputs themselves, as real remote hosts must)
    _, _, strand = prepare_data(strands_files, settings.skip_masked, None)
    total_len = int(len(strand.data)) - 1
    del strand
    windows = plan_windows(total_len, shards)

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="asgart_mh_")
        workdir = own_tmp.name
    try:
        parts = [os.path.join(workdir, f"window_{i:04d}.json")
                 for i in range(len(windows))]
        wenv = dict(os.environ)
        if env:
            wenv.update(env)
        # workers must import this package wherever they start from;
        # PRESERVE any existing PYTHONPATH (site plugins may live there)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        prev = wenv.get("PYTHONPATH", "")
        wenv["PYTHONPATH"] = (pkg_root + os.pathsep + prev) if prev \
            else pkg_root

        procs: list = [None] * len(windows)
        pending = list(range(len(windows)))
        running: list[int] = []
        failures: list[str] = []

        def reap(block: bool) -> None:
            for i in list(running):
                p = procs[i]
                if block:
                    p.wait()
                if p.poll() is not None:
                    running.remove(i)
                    if p.returncode != 0:
                        err = p.stderr.read().decode(errors="replace")
                        failures.append(
                            f"window {windows[i]} (rc={p.returncode}):\n"
                            + err[-2000:])
                    p.stderr.close()

        import time as _time

        while pending or running:
            while pending and len(running) < max(1, hosts) \
                    and not failures:
                i = pending.pop(0)
                argv = window_argv(strands_files, settings, windows[i],
                                   parts[i], engine=engine)
                log.info("multihost: launching window %s (%d/%d)",
                         windows[i], i + 1, len(windows))
                procs[i] = subprocess.Popen(
                    argv, env=wenv, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE)
                running.append(i)
            if failures:
                for i in running:
                    procs[i].kill()
                reap(block=True)
                break
            reap(block=False)
            if running:
                _time.sleep(0.2)
        if failures:
            raise RuntimeError("multihost window worker(s) failed:\n"
                               + "\n".join(failures))

        return merge_partials(parts, settings)
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
