"""The port end to end on the CPU: ``asgart_tpu_torch.pipeline
.search_duplications(engine="cuda", device=cpu)`` (the kernels' plain
versions) writes JSON byte-equal to the JAX fused engine
(``ASGART_FUSED=1``, ``engine="tpu"``, as tests/test_fused.py:32 runs it)
and to the host engine."""

import json
import os

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import _finalize_result, raw_families_to_protosds
from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu.structs import RunSettings
from asgart_tpu_torch.pipeline import search_duplications

from torch_jax_ref import (TRANSFORMS, json_text, specs_for, vocab_genome)
from torch_jax_ref import one_torch_thread  # noqa: F401  (autouse)
from util import plant_duplication, random_dna, revcomp, write_fasta

CPU = torch.device("cpu")


def _three_way(fa, settings, monkeypatch):
    """(port, JAX fused, host) JSON texts."""
    port = json_text(search_duplications([str(fa)], settings, engine="cuda",
                                         device=CPU))
    host = json_text(jax_search([str(fa)], settings, engine="host"))
    monkeypatch.setenv("ASGART_FUSED", "1")
    fused = json_text(jax_search([str(fa)], settings, engine="tpu"))
    monkeypatch.delenv("ASGART_FUSED")
    return port, fused, host


def _assert_equal(port, fused, host, min_sds=1):
    assert port == fused == host
    assert sum(len(f) for f in json.loads(port)["families"]) >= min_sds


@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_port_byte_equal_transforms(tmp_path, monkeypatch, reverse,
                                    complement):
    rng = np.random.default_rng(31)
    tf = {(False, False): None, (True, True): revcomp,
          (True, False): lambda s: s[::-1],
          (False, True): lambda s: s.translate(
              bytes.maketrans(b"ACGT", b"TGCA"))}[(reverse, complement)]
    g = plant_duplication(rng, 90000, 3000, 10000, 60000, noise=0.01,
                          transform=tf)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=reverse, complement=complement)
    _assert_equal(*_three_way(fa, s, monkeypatch))


@pytest.mark.parametrize("skip_masked", [False, True])
def test_port_byte_equal_chunked_masked(tmp_path, monkeypatch, skip_masked):
    """N-runs split chunks (> 5000 N), in-chunk N probes mask lanes, and a
    soft-masked stretch meets --skip-masked."""
    rng = np.random.default_rng(32)
    g = bytearray(plant_duplication(rng, 120000, 2500, 5000, 80000,
                                    noise=0.0, transform=revcomp))
    g[30000:36000] = b"N" * 6000
    g[70000:70100] = b"N" * 100
    g[90000:92000] = bytes(g[90000:92000]).lower()
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    s = RunSettings(reverse=True, complement=True, skip_masked=skip_masked)
    _assert_equal(*_three_way(fa, s, monkeypatch))


def test_port_byte_equal_multifasta(tmp_path, monkeypatch):
    rng = np.random.default_rng(33)
    g1 = plant_duplication(rng, 40000, 2000, 3000, 30000, noise=0.0)
    g2 = bytes(random_dna(rng, 25000))
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chrA", g1), ("chrB", g2)])
    _assert_equal(*_three_way(fa, RunSettings(), monkeypatch))


def test_port_byte_equal_k8(tmp_path, monkeypatch):
    rng = np.random.default_rng(35)
    g = plant_duplication(rng, 50000, 2000, 4000, 35000, noise=0.0,
                          transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=True, complement=True, probe_size=8)
    _assert_equal(*_three_way(fa, s, monkeypatch), min_sds=0)


def test_port_byte_equal_tied_vocabulary(tmp_path, monkeypatch):
    """Nearly every position tied: subset doubling runs to completion
    (the JAX fused build keeps its subset rounds below its bail-out)."""
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", vocab_genome())])
    s = RunSettings(reverse=True, complement=True)
    _assert_equal(*_three_way(fa, s, monkeypatch), min_sds=0)


def test_port_ecoli_like_golden(tmp_path):
    """The E. coli-like surrogate, direct, against its committed golden
    (tests/test_ecoli_like.py pins the golden to the host engine)."""
    from test_ecoli_like import GOLDEN_DIR, ecoli_like_genome

    fa = tmp_path / "ecoli_like.fa"
    body = ecoli_like_genome()
    with open(fa, "w") as fh:
        fh.write(">U00096.3-like\n")
        for i in range(0, len(body), 70):
            fh.write(body[i:i + 70].decode() + "\n")
    res = search_duplications([str(fa)], RunSettings(), engine="cuda",
                              device=CPU)
    text = json_text(res).replace(json.dumps(str(fa)), '"ecoli_like.fa"')
    with open(os.path.join(GOLDEN_DIR, "ecoli_like_direct.json")) as fh:
        assert text == fh.read()


@pytest.mark.parametrize("reverse,complement", [(True, True),
                                                (False, False)])
def test_port_scan_on_jax_index(tmp_path, reverse, complement):
    """A JAX-built FusedIndex carried across with convert.py drives the
    port's engine to the host engine's JSON."""
    from asgart_tpu.device_index import FusedIndex as JaxFusedIndex
    from asgart_tpu.fasta import prepare_data
    from asgart_tpu_torch.convert import fused_index_from_numpy
    from asgart_tpu_torch.device_engine import FusedEngine

    rng = np.random.default_rng(36)
    g = plant_duplication(rng, 60000, 2500, 5000, 40000, noise=0.01,
                          transform=revcomp if reverse else None)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=reverse, complement=complement)
    _, chunks, strand = prepare_data([str(fa)], False, None)
    specs = specs_for(chunks, s)
    ref = JaxFusedIndex.build(strand.data, s.probe_size, specs=specs,
                              reverse=reverse, complement=complement)
    idx = fused_index_from_numpy(
        np.asarray(ref.sa), np.asarray(ref.lane_lo), np.asarray(ref.lane_hi),
        np.asarray(ref.lane_mask), ref.specs, ref.offs, ref.k, ref.n,
        ref.first_len, ref.reverse, ref.complement, CPU)
    eng = FusedEngine(strand, s, CPU, index=idx)
    fams = []
    for (start, length), raw in zip(chunks, eng.run_chunks(chunks)):
        fams.extend(raw_families_to_protosds(raw, s, start, length))
    port = json_text(_finalize_result(fams, strand, s))
    host = json_text(jax_search([str(fa)], s, engine="host"))
    assert port == host
    assert sum(len(f) for f in json.loads(port)["families"]) >= 1
