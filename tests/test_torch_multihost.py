"""``--hosts N`` in the port (asgart_tpu_torch/multihost.py, a pinned copy
of asgart_tpu/multihost.py whose workers run the port's CLI): the port's
``search_duplications_multihost`` on its host engine against the JAX one
and against the port's in-process ``--shards`` run
(tests/test_multihost.py's cases), ``plan_windows``, the worker command,
a failing worker, and the CLI with ``--hosts 2`` against the JAX CLI's
bytes. Workers run on the CPU with one thread each."""

import subprocess

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest

from asgart_tpu import multihost as jax_multihost
from asgart_tpu.cli.main import main as jax_main
from asgart_tpu_torch import multihost
from asgart_tpu_torch.cli.main import main
from asgart_tpu_torch.pipeline import search_duplications
from asgart_tpu_torch.structs import RunResult, RunSettings

from torch_jax_ref import jax_settings, json_text
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import random_dna, revcomp, write_fasta

WENV = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


def _genome(rng, n=30000):
    """tests/test_multihost.py:24's genome: a duplication inside window 1,
    one inside window 2, and one whose arms lie in different windows."""
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[3000:4500] = bytes(g[500:2000])
    g[n - 6000:n - 4500] = bytes(g[n // 2 + 1000:n // 2 + 2500])
    g[n - 3000:n - 1500] = bytes(g[6000:7500])
    return bytes(g)


def test_plan_windows_equals_jax():
    for total, shards in ((100, 2), (101, 2), (5, 8), (29999, 3), (7, 1)):
        assert multihost.plan_windows(total, shards) == \
            jax_multihost.plan_windows(total, shards)


@pytest.mark.parametrize("case", ["direct", "rc_three_windows"])
def test_multihost_equals_jax_and_inprocess_shards(tmp_path, case):
    """tests/test_multihost.py:46 (two windows on two hosts) and :61
    (-RC, three windows queued on two hosts)."""
    rng = np.random.default_rng(90 if case == "direct" else 91)
    fa = tmp_path / "g.fa"
    if case == "direct":
        write_fasta(fa, [("chr1", _genome(rng))])
        s, shards = RunSettings(min_duplication_length=800), 2
    else:
        g = bytearray(random_dna(rng, 24000, b"ACGT"))
        g[18000:19500] = revcomp(bytes(g[2000:3500]))
        write_fasta(fa, [("chr1", bytes(g))])
        s, shards = RunSettings(min_duplication_length=800, reverse=True,
                                complement=True), 3
    fa = str(fa)
    mh = multihost.search_duplications_multihost(
        [fa], s, shards=shards, hosts=2, engine="host", env=WENV)
    assert type(mh) is RunResult
    want = json_text(jax_multihost.search_duplications_multihost(
        [fa], jax_settings(s), shards=shards, hosts=2, engine="host",
        env=WENV))
    assert json_text(mh) == want
    assert json_text(search_duplications([fa], s, engine="host",
                                         shards=shards)) == want
    assert mh.families


def test_multihost_worker_failure_propagates(tmp_path):
    fa = tmp_path / "missing_dir" / "nope.fa"
    with pytest.raises((RuntimeError, OSError)):
        multihost.search_duplications_multihost(
            [str(fa)], RunSettings(), shards=2, hosts=2, engine="host",
            env=WENV)


def test_window_argv_runs_the_ports_cli(tmp_path):
    """The worker command is the port's CLI (the one line that differs
    from the JAX module), and runs on its own."""
    import os

    rng = np.random.default_rng(92)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", _genome(rng, 20000))])
    s = RunSettings(min_duplication_length=800, reverse=True)
    out = tmp_path / "part0.json"
    argv = multihost.window_argv([str(fa)], s, (0, 10000), str(out))
    jargv = jax_multihost.window_argv([str(fa)], jax_settings(s), (0, 10000),
                                      str(out))
    assert argv[1:3] == ["-m", "asgart_tpu_torch.cli.main"]
    assert argv[:1] + argv[3:] == jargv[:1] + jargv[3:]
    env = dict(os.environ, **WENV)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    cp = subprocess.run(argv, env=env, capture_output=True, timeout=300)
    assert cp.returncode == 0, cp.stderr.decode()
    assert RunResult.from_file(str(out)).settings.trim == (0, 10000)


def test_cli_hosts_equals_jax_cli(tmp_path, monkeypatch):
    """``--hosts 2`` (shards defaulting to 2) through the port's CLI
    writes the JAX CLI's bytes; the port's CLI used to exit 1 (F10)."""
    for name, value in WENV.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(93)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", _genome(rng))])
    outs = [tmp_path / f"{side}.json" for side in ("port", "jax")]
    for run, out in zip((main, jax_main), outs):
        assert run([str(fa), "--min-length", "800", "--hosts", "2",
                    "--threads", "1", "--out", str(out)]) == 0
    assert outs[0].read_text() == outs[1].read_text()
    assert RunResult.from_file(str(outs[0])).families
