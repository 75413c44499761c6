"""``ASGART_DEVICE_CHAIN=1`` through the port's pipeline on the CPU
(``search_duplications(engine="cuda", device=cpu)``, KD's and KN's plain
versions): every device engine chains its chunks' events with KN in place
of ``native.chain_events``, and writes the bytes of the port's host engine
and of the JAX ``engine="tpu"`` run under the same variable (whose
``_chain_merged`` takes ``chain_jax.chain_events_device``,
asgart_tpu/device_engine.py:1495):

- the fused engine on the whole genome, on tests/test_device_engine.py:234's
  planted-duplication input, and -RC on a genome split into chunks;
- the table engine with ``--checkpoint``: the journaled run and its
  resumed rerun;
- the merge-join engine on a trim window (the window start added to the
  matches by KN);
- ``--shards`` on the fused windows (the chain on the device thread, the
  tail thread post-processing only);

and no route calls the host chain while the variable is set.
"""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch import device_engine, native, pipeline
from asgart_tpu_torch.pipeline import search_duplications
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import chunked_genome, jax_settings, json_text
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import random_dna, write_fasta

CPU = torch.device("cpu")


def _planted(tmp_path) -> str:
    """tests/test_device_engine.py:234's genome: two direct copies with
    long quiet gaps between them (several bursts)."""
    rng = np.random.default_rng(64)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[9000:11500] = bytes(g[2000:4500])
    g[30000:31500] = bytes(g[21000:22500])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    return str(fa)


def _port(fa, s, **kw):
    return json_text(search_duplications([fa], s, engine="cuda", device=CPU,
                                         **kw))


def _host(fa, s, **kw):
    """The port's host engine (its full-stream ``native.chain``)."""
    return json_text(search_duplications([fa], s, engine="host", **kw))


def _jax_tpu(fa, s, **kw):
    return json_text(jax_search([fa], jax_settings(s), engine="tpu", **kw))


@pytest.fixture
def on_device(monkeypatch):
    """The variable set, and the host event chain made to raise: every
    chain of a device engine must be KN's (the host engine's full-stream
    ``native.chain`` is left alone)."""
    monkeypatch.setenv("ASGART_DEVICE_CHAIN", "1")

    def no_host_chain(*a, **kw):
        raise AssertionError("the host chain ran under ASGART_DEVICE_CHAIN")

    monkeypatch.setattr(native, "chain_events", no_host_chain)


def _passes(run):
    """KN's plain passes during ``run()`` (the plain version counts no
    launch; its calls are counted here)."""
    calls = []
    orig = device_engine.chain_events_tensors

    def spy(ev, cfg, *a, **kw):
        out = orig(ev, cfg, *a, **kw)
        calls.append(out[1].passes)
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(device_engine, "chain_events_tensors", spy)
        text = run()
    return text, calls


def test_fused_whole_genome(tmp_path, monkeypatch, on_device):
    """The fused engine on :234's input, direct at min_duplication_length
    900: the host engine's bytes and the JAX device chain's."""
    fa = _planted(tmp_path)
    s = RunSettings(min_duplication_length=900)
    port, calls = _passes(lambda: _port(fa, s))
    assert calls and all(c >= 1 for c in calls)
    assert port == _host(fa, s)
    assert port == _jax_tpu(fa, s)
    assert port.count("chr_left_position") >= 2


def test_fused_reverse_complement_chunks(tmp_path, monkeypatch, on_device):
    """-RC on a genome whose N runs split it into chunks, with a planted
    reverse-complement copy (torch_jax_ref.chunked_genome): each chunk
    chained on its own, the host engine's bytes and the JAX device
    chain's."""
    fa = tmp_path / "c.fa"
    write_fasta(fa, [("chr1", chunked_genome())])
    s = RunSettings(reverse=True, complement=True)
    port, calls = _passes(lambda: _port(str(fa), s))
    assert len(calls) >= 1
    assert port == _host(str(fa), s)
    assert port == _jax_tpu(str(fa), s)
    assert port.count("chr_left_position") >= 1


def test_table_journal(tmp_path, monkeypatch, on_device):
    """The table engine (the fused build made not to fit) with a journal:
    the journaled run and the resumed rerun write the host engine's
    bytes and the JAX table engine's under the variable."""
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    fa = _planted(tmp_path)
    s = RunSettings(min_duplication_length=900)
    scans = []
    orig = pipeline.TableEngine.run_chunk
    monkeypatch.setattr(pipeline.TableEngine, "run_chunk",
                        lambda eng, c: scans.append(c) or orig(eng, c))
    journal = str(tmp_path / "run.jsonl")
    port, calls = _passes(lambda: _port(fa, s, checkpoint=journal))
    assert scans and len(calls) == len(scans)
    host = _host(fa, s)
    assert port == host
    n = len(scans)
    assert _port(fa, s, checkpoint=journal) == host  # resumed
    assert len(scans) == n  # nothing rescanned
    assert _jax_tpu(fa, s, checkpoint=str(tmp_path / "jax.jsonl")) == host


def test_merge_join_trim(tmp_path, monkeypatch, on_device):
    """The merge-join engine on a trim window (no fused build): KN adds
    the window start to the matches; the JAX ``DeviceWindowEngine``
    (``ASGART_FUSED=0``) under the variable."""
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    monkeypatch.setenv("ASGART_FUSED", "0")
    fa = _planted(tmp_path)
    s = RunSettings(min_duplication_length=900, trim=(5000, 36000))
    port, calls = _passes(lambda: _port(fa, s))
    assert calls
    assert port == _host(fa, s)
    assert port == _jax_tpu(fa, s)
    assert port.count("chr_left_position") >= 2


def test_shards(tmp_path, monkeypatch, on_device):
    """``--shards 3`` on the fused windows: each window chained on the
    device thread; the host engine's and the JAX sharded run's bytes."""
    fa = _planted(tmp_path)
    s = RunSettings(min_duplication_length=900)
    tails = []
    orig = pipeline._window_tail

    def spy(events, *a):
        # every chunk's raw families, none left for the host chain
        tails.append(all(isinstance(r, list) for r in events))
        return orig(events, *a)

    monkeypatch.setattr(pipeline, "_window_tail", spy)
    port, calls = _passes(lambda: _port(fa, s, shards=3))
    assert tails == [True] * 3 and calls
    assert port == _host(fa, s, shards=3)
    assert port == _jax_tpu(fa, s, shards=3)


def test_variable_unset_takes_host_chain(tmp_path, monkeypatch):
    """Without the variable nothing changes: the host chain runs, KN's
    plain version does not."""
    monkeypatch.delenv("ASGART_DEVICE_CHAIN", raising=False)
    fa = _planted(tmp_path)
    s = RunSettings(min_duplication_length=900)
    port, calls = _passes(lambda: _port(fa, s))
    assert calls == []
    assert port == _host(fa, s)
