"""Trim windows and ``--shards`` end to end on the CPU:
``asgart_tpu_torch.pipeline.search_duplications(engine="cuda",
device=cpu)`` (the kernels' plain versions) with ``settings.trim`` writes
JSON byte-equal to the JAX host engine and to the JAX fused window engine
(``ASGART_FUSED=1``, ``engine="tpu"``: its one-device ``FusedEngine(trim=)``
route); with ``shards=S`` byte-equal to the JAX host engine with the same
S, with each window's host tail overlapping the next window. The JAX ``engine="tpu"`` sharded route is not
run here: on the virtual 8-device mesh it is ``MeshWindowEngine``
(collectives). Also the auto-shard planner and every refusal."""

import json
import logging

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch import pipeline
from asgart_tpu_torch.fused_index import (MJ_BYTES_PER_LANE,
                                          MJ_KEY_BYTES_PER_LANE,
                                          MJ_PEAK_BYTES_PER_ROW,
                                          PEAK_BYTES_PER_ROW)
from asgart_tpu_torch.pipeline import plan_shards, search_duplications
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import (TRANSFORMS, jax_settings, json_text,
                           masked_multifasta)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import plant_duplication, revcomp, write_fasta

CPU = torch.device("cpu")
PLANT = {(False, False): None, (True, True): revcomp,
         (True, False): lambda s: s[::-1],
         (False, True): lambda s: s.translate(
             bytes.maketrans(b"ACGT", b"TGCA"))}


def _genome(tmp_path, reverse=True, complement=True):
    """90 kbp with a planted duplication 10000 -> 60000 of the searched
    transform."""
    rng = np.random.default_rng(41)
    g = plant_duplication(rng, 90000, 3000, 10000, 60000, noise=0.01,
                          transform=PLANT[(reverse, complement)])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    return str(fa)


def _port(fa, s, **kw):
    return json_text(search_duplications([fa], s, engine="cuda", device=CPU,
                                         **kw))


def _jax_host(fa, s, **kw):
    return json_text(jax_search([fa], jax_settings(s), engine="host", **kw))


def _jax_fused_window(fa, s, monkeypatch):
    monkeypatch.setenv("ASGART_FUSED", "1")
    try:
        return json_text(jax_search([fa], jax_settings(s), engine="tpu"))
    finally:
        monkeypatch.delenv("ASGART_FUSED")


def _sds(text):
    return sum(len(f) for f in json.loads(text)["families"])


@pytest.mark.parametrize("trim", [(5000, 70000), (0, 30000),
                                  (40000, 89999)])
@pytest.mark.parametrize("k", [20, 25])
def test_trim_json_equals_jax(tmp_path, monkeypatch, k, trim):
    """-RC windows holding both arms, only the left one (reference trim
    semantics: no family) and the genome's end, at one- and two-word
    keys."""
    fa = _genome(tmp_path)
    s = RunSettings(reverse=True, complement=True, probe_size=k, trim=trim)
    port = _port(fa, s)
    assert port == _jax_host(fa, s)
    assert port == _jax_fused_window(fa, s, monkeypatch)
    assert _sds(port) == (0 if trim == (0, 30000) else 1)


@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_trim_json_equals_jax_transforms(tmp_path, monkeypatch, reverse,
                                         complement):
    fa = _genome(tmp_path, reverse, complement)
    s = RunSettings(reverse=reverse, complement=complement,
                    trim=(8000, 64000))
    port = _port(fa, s)
    assert port == _jax_host(fa, s)
    assert port == _jax_fused_window(fa, s, monkeypatch)
    assert _sds(port) >= 1


@pytest.mark.parametrize("skip_masked", [False, True])
@pytest.mark.parametrize("trim", [(1000, 30000), (23900, 39000)])
def test_trim_json_masked_multifasta(tmp_path, monkeypatch, skip_masked,
                                     trim):
    """Soft-masked runs, IUPAC bytes and an N run across the fragment
    boundary (tests/test_adversarial_pins.py:103's genome), -RC and
    direct."""
    fa = tmp_path / "g.fa"
    write_fasta(fa, masked_multifasta())
    for kw in ({}, dict(reverse=True, complement=True)):
        s = RunSettings(min_duplication_length=800, trim=trim,
                        skip_masked=skip_masked, **kw)
        port = _port(str(fa), s)
        assert port == _jax_host(str(fa), s)
        assert port == _jax_fused_window(str(fa), s, monkeypatch)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("k", [20, 25])
def test_shards_json_equals_jax_host(tmp_path, k, shards):
    """The port's device windows (and its host engine's) concatenated in
    window order: the JAX host engine's sharded bytes."""
    fa = _genome(tmp_path)
    s = RunSettings(reverse=True, complement=True, probe_size=k)
    want = _jax_host(fa, s, shards=shards)
    assert _port(fa, s, shards=shards) == want
    assert json_text(search_duplications([fa], s, engine="host",
                                         shards=shards)) == want
    assert _sds(want) >= 1


def test_shards_json_masked_multifasta(tmp_path):
    fa = tmp_path / "g.fa"
    write_fasta(fa, masked_multifasta())
    for kw in ({}, dict(reverse=True, complement=True, skip_masked=True)):
        s = RunSettings(min_duplication_length=800, **kw)
        assert _port(str(fa), s, shards=3) == _jax_host(str(fa), s,
                                                        shards=3)


def test_plan_shards():
    """The smallest S whose windows fit, in a fused build or (k <= 20) in
    the merge-join engine with the run's probe keys held beside each
    window's build, from (n1, k, doubled, free bytes) alone."""
    n1 = 128_000_001
    step_rows = n1 // 10 + (1 << 21)
    lanes = n1 // 10

    def window(S):
        return (n1 - 1 + S - 1) // S + 1

    def mj(S):
        W = window(S)
        return max(MJ_PEAK_BYTES_PER_ROW * W + MJ_KEY_BYTES_PER_LANE * lanes,
                   12 * W + MJ_BYTES_PER_LANE * lanes) + n1

    for S in (2, 3, 5, 17):
        fused = (window(S) + step_rows) * PEAK_BYTES_PER_ROW[1] + n1
        # at k = 20 the merge-join engine holds a window in fewer bytes
        assert mj(S) < fused
        assert plan_shards(n1, 20, True, mj(S)) == S
        assert plan_shards(n1, 20, True, mj(S) - 1) == S + 1
    assert plan_shards(n1, 20, True, float("inf")) == 2
    # two-word keys: the fused build alone (more bytes per row, probe
    # step 12 fewer lanes)
    W4 = window(4)
    need = (W4 + n1 // 12 + (1 << 21)) * PEAK_BYTES_PER_ROW[2] + n1
    assert plan_shards(n1, 25, False, need) == 4
    assert plan_shards(n1, 25, False, need - 1) == 5
    # nothing fits: the probe side alone outgrows the budget
    assert plan_shards(n1, 20, True, mj(256) - 1) is None
    # beyond int32 probe addressing: the doubled text of -R/-C runs
    assert plan_shards(2**30 + 1, 20, True, float("inf")) is None
    assert plan_shards(2**30 + 1, 20, False, float("inf")) == 2


def test_auto_shard(tmp_path, monkeypatch, caplog):
    """A genome whose whole fused build and one-window merge join do not
    fit runs sharded into the planner's S windows, byte-equal to the JAX
    host engine's S windows; when no S fits, the run raises."""
    fa = _genome(tmp_path)
    s = RunSettings(reverse=True, complement=True)
    # the whole genome (W = n1) does not fit; its windows do
    monkeypatch.setattr(pipeline, "fits", lambda n1, W, *a, **kw: W != n1)
    monkeypatch.setattr(pipeline, "mj_fits", lambda *a, **kw: False)
    monkeypatch.setattr(pipeline, "plan_shards", lambda *a: 3)
    with caplog.at_level(logging.WARNING, logger="asgart"):
        got = _port(fa, s)
    assert "auto-sharding into 3 trim windows" in caplog.text
    assert got == _jax_host(fa, s, shards=3)
    monkeypatch.setattr(pipeline, "plan_shards", lambda *a: None)
    with pytest.raises(NotImplementedError, match="fits no device route"):
        _port(fa, s)


def test_refusals(tmp_path, monkeypatch, caplog):
    fa = _genome(tmp_path)
    s = RunSettings(reverse=True, complement=True, trim=(5000, 70000))
    for engine in ("host", "cuda"):
        with pytest.raises(ValueError, match="--shards cannot be combined"):
            search_duplications([fa], s, engine=engine, device=CPU,
                                shards=2)
    # --checkpoint and --index-cache warn and are ignored with --shards
    plain = RunSettings(reverse=True, complement=True)
    with caplog.at_level(logging.WARNING, logger="asgart"):
        got = _port(fa, plain, shards=2, checkpoint=str(tmp_path / "c"),
                    index_cache=str(tmp_path / "ic"))
    assert "--checkpoint is not supported with --shards" in caplog.text
    assert "--index-cache applies to whole-genome" in caplog.text
    assert got == _jax_host(fa, plain, shards=2)
    # a window that neither the fused build nor the merge-join engine
    # holds on the device
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    monkeypatch.setattr(pipeline, "mj_fits", lambda *a, **kw: False)
    with pytest.raises(NotImplementedError, match="fits no device route"):
        _port(fa, s)
    with pytest.raises(NotImplementedError, match="fits no device route"):
        _port(fa, plain, shards=2)
    # beyond int32 probe addressing
    monkeypatch.setattr(pipeline, "probe_span", lambda *a: 2**31)
    with pytest.raises(NotImplementedError, match="A10"):
        _port(fa, s)
    with pytest.raises(NotImplementedError, match="A10"):
        _port(fa, plain)


@pytest.mark.parametrize("phase", ["device", "tail"])
def test_failing_window_fails_the_run(tmp_path, monkeypatch, phase):
    """A window whose device phase or host tail raises fails the run: no
    rerun, no host-engine fallback. A failing tail does not stop the next
    window's device phase and tail, which overlap it."""
    fa = _genome(tmp_path)
    calls = []

    def failing(orig):
        def wrapped(*a, **kw):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("window 2 failed")
            return orig(*a, **kw)
        return wrapped

    if phase == "device":
        monkeypatch.setattr(pipeline.FusedEngine, "scan_chunks",
                            failing(pipeline.FusedEngine.scan_chunks))
    else:
        monkeypatch.setattr(pipeline, "chain_chunk_events",
                            failing(pipeline.chain_chunk_events))
    monkeypatch.setattr(pipeline, "SearchEngine", None)  # no host fallback
    with pytest.raises(RuntimeError, match="window 2 failed"):
        _port(fa, RunSettings(reverse=True, complement=True), shards=3)
    assert len(calls) == (2 if phase == "device" else 3)


def test_cli_trim_and_shards(tmp_path, capsys):
    """``--shards`` through the CLI writes the JAX CLI's bytes; ``--trim``
    with ``--shards`` is refused."""
    from asgart_tpu.cli.main import main as jax_main
    from asgart_tpu_torch.cli.main import main

    fa = _genome(tmp_path)
    outs = [tmp_path / "port.json", tmp_path / "jax.json"]
    assert main([fa, "-R", "-C", "--shards", "3", "--out",
                 str(outs[0])]) == 0
    assert jax_main([fa, "-R", "-C", "--shards", "3", "--out",
                     str(outs[1])]) == 0
    assert outs[0].read_text() == outs[1].read_text()
    assert main([fa, "--trim", "10", "5000", "--shards", "2", "--out",
                 str(tmp_path / "x.json")]) == 1
    assert "--shards cannot be combined" in capsys.readouterr().err
