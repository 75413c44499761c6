"""The port end to end on the CPU at probe sizes k = 21..30 (two-word
keys): ``asgart_tpu_torch.pipeline.search_duplications(engine="cuda",
device=cpu)`` writes JSON byte-equal to the JAX fused engine
(``ASGART_FUSED=1``, its 3-plane build) and to the host engine, for the
four transforms; to the JAX 3-plane table engine where the JAX fused
build bails out; and k = 31 still raises on the cuda engine."""

import json

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.pipeline import search_duplications

from torch_jax_ref import TRANSFORMS, jax_settings, json_text, vocab_genome
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import plant_duplication, revcomp, write_fasta

CPU = torch.device("cpu")

_PLANT = {(False, False): None, (True, True): revcomp,
          (True, False): lambda s: s[::-1],
          (False, True): lambda s: s.translate(
              bytes.maketrans(b"ACGT", b"TGCA"))}


def _port(fa, s):
    return json_text(search_duplications([str(fa)], s, engine="cuda",
                                         device=CPU))


def _jax_fused(fa, s, monkeypatch):
    monkeypatch.setenv("ASGART_FUSED", "1")
    try:
        return json_text(jax_search([str(fa)], jax_settings(s),
                                    engine="tpu"))
    finally:
        monkeypatch.delenv("ASGART_FUSED")


@pytest.mark.parametrize("k", [21, 25, 30])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_port_byte_equal_wide_k(tmp_path, monkeypatch, reverse, complement,
                                k):
    rng = np.random.default_rng(37)
    g = plant_duplication(rng, 60000, 3000, 8000, 40000, noise=0.01,
                          transform=_PLANT[(reverse, complement)])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    port = _port(fa, s)
    assert port == _jax_fused(fa, s, monkeypatch)
    assert port == json_text(jax_search([str(fa)], jax_settings(s),
                                        engine="host"))
    assert sum(len(f) for f in json.loads(port)["families"]) >= 1


def test_port_equals_jax_table_engine_k25(tmp_path, monkeypatch):
    """The tied vocabulary at k = 25 with the JAX fused bail-out lowered:
    JAX falls back to its 3-plane table engine (as tests/test_fused.py
    does at k = 20); the port's subset rounds need no fallback."""
    import asgart_tpu.device_index as di

    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", vocab_genome())])
    s = RunSettings(reverse=True, complement=True, probe_size=25)
    monkeypatch.setattr(di, "FUSED_TIED_BAILOUT_MIN", 64)
    bailed = {}
    orig = di.FusedIndex.build.__func__

    def spy(cls, *a, **kw):
        try:
            return orig(cls, *a, **kw)
        except di.FusedTiedOverflow:
            bailed["yes"] = True
            raise

    monkeypatch.setattr(di.FusedIndex, "build", classmethod(spy))
    table = _jax_fused(fa, s, monkeypatch)
    assert bailed.get("yes")
    assert _port(fa, s) == table


def test_probe_size_31_raises(tmp_path, capsys):
    """k > 30 has no device route (the JAX package runs it on its host
    engine): the cuda engine and the CLI refuse it, naming that engine."""
    from asgart_tpu_torch.cli.main import main

    rng = np.random.default_rng(38)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", plant_duplication(rng, 20000, 2000, 3000,
                                                12000, noise=0.0))])
    for k in (31, 40):
        s = RunSettings(reverse=True, complement=True, probe_size=k)
        with pytest.raises(NotImplementedError, match="host engine"):
            search_duplications([str(fa)], s, engine="cuda", device=CPU)
    out = tmp_path / "out.json"
    assert main([str(fa), "-k", "31", "--engine", "cuda",
                 "--out", str(out)]) == 1
    assert "host engine" in capsys.readouterr().err
    assert not out.exists()
