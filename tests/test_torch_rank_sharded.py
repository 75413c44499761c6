"""The rank-sharded window engine (asgart_tpu_torch ``ShardedWindowEngine``,
``ShardedWindowIndex`` and KT ``gather_owned``) against the JAX one on the
conftest's 8-device CPU mesh: per-shard KH summed against
``_sharded_window_ranges_fn``, KT's plain version per shard summed and
then KD's against ``_sharded_window_core_fn`` (the live prefixes of
``ev_pack``, ``m_flat`` and ``scalars``), KT at shard boundaries, across
three shards and on shards that own no row, the host build's one-word keys
against the device build, and ``search_duplications`` with
``ASGART_RANK_SHARDED=1`` (one rank) against the JAX rank-sharded engine
and the host engine (tests/test_rank_sharded.py's cases). Exact
(integers, JSON bytes; tolerance 0)."""

import json

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu_torch import pipeline
from asgart_tpu_torch.device_engine import chunk_specs, rebased_bases
from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.kernels import pack_keys
from asgart_tpu_torch.kernels.merge_join import mj_ranges_plain
from asgart_tpu_torch.kernels.scan_core import scan_core_plain
from asgart_tpu_torch.kernels.sharded import csr_offsets, gather_owned
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.window_index import (DeviceWindowIndex,
                                           ShardedWindowIndex)

from torch_jax_ref import (TRANSFORMS, dist_genome, jax_settings,
                           json_text, prepared)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import plant_duplication, random_dna, revcomp, write_fasta

CPU = torch.device("cpu")
D = 8  # the conftest's virtual devices


def _shards(strand, k, trim, reverse, complement, host_build=False):
    return [ShardedWindowIndex.build(strand.data, k, trim, reverse,
                                     complement, CPU, r, D, host_build)
            for r in range(D)]


def _jax_engine(fa, settings):
    from asgart_tpu.device_engine import ShardedWindowEngine
    from asgart_tpu.fasta import prepare_data

    _, chunks, strand = prepare_data([fa], False, None)
    return ShardedWindowEngine(strand, jax_settings(settings),
                               settings.trim, host_build=True), chunks


@pytest.mark.parametrize("k", [20, 12])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS[:2])
def test_stages_equal_jax_shard_map(tmp_path, reverse, complement, k):
    """Stage 1: each shard's ``mj_ranges_plain`` summed equals
    ``_sharded_window_ranges_fn``'s lo / hi / mask / total. Stage 2: KT's
    plain version on each shard, summed, then ``scan_core_plain`` over the
    gathered buffer equals ``_sharded_window_core_fn``'s outputs."""
    g, trim = dist_genome()  # a direct and a reverse-complement pair
    g = g[:30000] + b"N" * 6000 + g[36000:]  # two chunks
    s = RunSettings(probe_size=k, reverse=reverse, complement=complement,
                    trim=trim)
    fa, chunks, strand = prepared(tmp_path, [("chr1", g)])
    jeng, jchunks = _jax_engine(fa, s)
    assert jeng.Wl == -(-jeng.W // D)
    shards = _shards(strand, k, trim, reverse, complement)
    specs = chunk_specs(chunks, s)
    assert len(specs) >= 2
    lane_off = [0]
    for (_, _, nc) in specs:
        lane_off.append(lane_off[-1] + nc)
    (pkey,), mask = pack_keys(torch.from_numpy(CODE[strand.data]), specs, k,
                              reverse, complement, 0, lane_off[-1])
    parts = [mj_ranges_plain(sh.key, pkey, mask, lane_off) for sh in shards]
    lo, hi, totals = (sum(p[i].long() for p in parts) for i in range(3))
    n_events = 0
    for c, (cs, cl, nc) in enumerate(specs):
        jlo, jhi, jmask, jtot = (np.asarray(a) for a in
                                 jeng._stage1_for((cs, cl)))
        sl = slice(lane_off[c], lane_off[c + 1])
        assert np.array_equal(mask[sl].numpy(), jmask[:nc])
        assert not jmask[nc:].any()
        assert np.array_equal(lo[sl].numpy(), jlo[:nc])
        assert np.array_equal(hi[sl].numpy(), jhi[:nc])
        assert int(totals[c]) == int(jtot)
        l32, h32, m = lo[sl].int(), hi[sl].int(), mask[sl]
        off, total = csr_offsets(l32, h32, m)
        flat = sum(gather_owned(l32, h32, m, off, total, sh.sa, sh.row0)
                   .long() for sh in shards).int()
        end = (off + torch.where(m, h32 - l32, 0)).int()
        res = scan_core_plain(off.int(), end, m, flat,
                              *rebased_bases(cs, cl, trim[0], jeng.W),
                              s.max_cardinality, 0, k, reverse)
        st = jeng._dispatch_chunk((cs, cl))
        ev_pack, m_flat, scalars = (np.asarray(a) for a in st["shards"][0])
        ev, mf, z_trail = res.to_host()
        assert [res.n_events, res.total_kept, z_trail, 0] == \
            scalars.tolist()
        assert np.array_equal(ev, ev_pack[:, :res.n_events])
        assert np.array_equal(mf, m_flat[:res.total_kept])
        n_events += res.n_events
    assert n_events > 0


def _lanes(pairs):
    lo = torch.tensor([a for a, _ in pairs], dtype=torch.int32)
    hi = torch.tensor([b for _, b in pairs], dtype=torch.int32)
    return lo, hi


@pytest.mark.parametrize("case", ["boundary", "three_shards", "empty"])
def test_gather_owned_shards_sum_to_windows(case):
    """Every shard's KT buffer (plain version) summed gives each masked
    lane's window of ``sa``: a lane that ends at a shard boundary, one that
    spans three shards, lanes inside one shard, an empty window and a
    masked lane; ``empty``: more ranks than rows, so the last ranks own
    none and write zeros."""
    rng = np.random.default_rng(3)
    W, n_ranks = {"boundary": (30, 4), "three_shards": (30, 4),
                  "empty": (5, 8)}[case]
    Wl = -(-W // n_ranks)
    sa = torch.from_numpy(rng.permutation(W).astype(np.int32))
    if case == "boundary":
        pairs = [(3, 8), (8, 16), (0, 0), (29, 30), (16, 24)]
    elif case == "three_shards":
        pairs = [(5, 20), (2, 3), (7, 7), (0, 30)]
    else:
        pairs = [(0, 5), (4, 5), (2, 2)]
    pairs.append((1, 4))
    lo, hi = _lanes(pairs)
    mask = torch.ones(len(pairs), dtype=torch.bool)
    mask[-1] = False  # masked lanes keep their bounds but are skipped
    off, total = csr_offsets(lo, hi, mask)
    want = torch.cat([sa[a:b] for (a, b), m in zip(pairs, mask) if m])
    assert total == want.numel()
    got = torch.zeros(total, dtype=torch.int64)
    for r in range(n_ranks):
        a, b = min(W, r * Wl), min(W, (r + 1) * Wl)
        part = gather_owned(lo, hi, mask, off, total, sa[a:b].clone(), a)
        if a == b:
            assert not part.any()
        got += part
    assert torch.equal(got.int(), want)
    if case == "empty":
        assert min(W, (n_ranks - 1) * Wl) == W  # the last rank owns none


def test_mj_ranges_on_empty_shard():
    """KH (plain version) on a shard that owns no row: every lane's range
    is empty and every total 0."""
    pkey = torch.tensor([5, 9, 3], dtype=torch.int64) << 1 | 1
    mask = torch.tensor([True, False, True])
    lo, hi, totals = mj_ranges_plain(torch.zeros(0, dtype=torch.int64),
                                     pkey, mask, [0, 2, 3])
    assert not lo.any() and not hi.any() and not totals.any()


@pytest.mark.parametrize("n_ranks", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_build_keys_equal_device_build(seed, n_ranks):
    """The host build's shards (``host_window_arrays``' two planes packed
    into the one-word key) equal the device build's, bit for bit, and
    concatenate to the merge-join index (tests/test_rank_sharded.py:23);
    a window of 11 rows over 8 ranks leaves the last two without a row."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 6000))
    data = np.frombuffer(random_dna(rng, n, b"ACGT" if seed else b"ACG")
                         + b"$", np.uint8)
    for trim in ((100, n - 200), (100, 110)):
        whole = DeviceWindowIndex.build(data, 20, trim, False, False, CPU)
        keys, sas = [], []
        for r in range(n_ranks):
            built = [ShardedWindowIndex.build(data, 20, trim, False, False,
                                              CPU, r, n_ranks, hb)
                     for hb in (False, True)]
            assert torch.equal(built[0].key, built[1].key)
            assert torch.equal(built[0].sa, built[1].sa)
            keys.append(built[0].key)
            sas.append(built[0].sa)
            if trim == (100, 110) and n_ranks == 8 and r >= 6:
                assert built[0].key.numel() == 0
        assert torch.equal(torch.cat(keys), whole.key)
        assert torch.equal(torch.cat(sas), whole.sa)


def _trim_case(tmp_path, case):
    """tests/test_rank_sharded.py's direct (:48) and RC (:57) cases."""
    if case == "direct":
        rng = np.random.default_rng(70)
        body = plant_duplication(rng, 30000, 2000, 5000, 20000, noise=0.01)
        s = RunSettings(trim=(2000, 26000))
    else:
        rng = np.random.default_rng(71)
        body = plant_duplication(rng, 24000, 1500, 3000, 15000,
                                 transform=revcomp)
        s = RunSettings(reverse=True, complement=True, trim=(1000, 20000))
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", body)])
    return str(fa), s


@pytest.mark.parametrize("case", ["direct", "rc"])
def test_rank_sharded_json_equals_jax_and_host(tmp_path, monkeypatch, case):
    """``search_duplications(engine="cuda")`` on the CPU with
    ``ASGART_RANK_SHARDED=1`` (the fused build refused, as the JAX gate
    refuses it on a mesh), with the device build and with
    ``ASGART_RSH_HOST_BUILD=1``, writes the JAX rank-sharded engine's
    bytes and the host engine's."""
    from asgart_tpu import device_engine as jde
    from asgart_tpu.pipeline import search_duplications as jax_search

    from asgart_tpu_torch import device_engine as de
    from asgart_tpu_torch.pipeline import search_duplications

    fa, s = _trim_case(tmp_path, case)
    host = json_text(search_duplications([fa], s, engine="host"))
    monkeypatch.setenv("ASGART_RANK_SHARDED", "1")
    built = []
    orig = jde.ShardedWindowEngine.__init__

    def spy(self, *a, **kw):
        built.append(1)
        orig(self, *a, **kw)

    monkeypatch.setattr(jde.ShardedWindowEngine, "__init__", spy)
    assert json_text(jax_search([fa], jax_settings(s), engine="tpu")) == host
    assert built
    monkeypatch.setattr(pipeline, "fits", lambda *a, **k: False)
    engines = []
    orig_scan = de.ShardedWindowEngine.scan_results

    def scan_spy(self, chunks):
        engines.append(type(self.ensure_index()).__name__)
        return orig_scan(self, chunks)

    monkeypatch.setattr(de.ShardedWindowEngine, "scan_results", scan_spy)
    for hb in ("0", "1"):
        monkeypatch.setenv("ASGART_RSH_HOST_BUILD", hb)
        got = json_text(search_duplications([fa], s, engine="cuda",
                                            device=CPU))
        assert got == host, hb
    assert engines == ["ShardedWindowIndex"] * 2
    assert json.loads(host)["families"]

