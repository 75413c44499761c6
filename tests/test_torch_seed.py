"""The port's seed lookups (asgart_tpu_torch/seed.py: KQ ``equal_range``,
KR ``gather_ranges`` in its two forms, KS ``pack_probe_planes``, through
their plain versions on CPU tensors) against the JAX package's
(asgart_tpu/seed.py) on the same numpy inputs: the functions, the two
device classes and their host arithmetic (prefix bits, shift, bucket
table, search depth, the ``ValueError``s), ``SearchEngine(engine="cuda",
device=cpu).run_chunk`` against the JAX ``SearchEngine(engine="tpu")``,
and the k = 21 whole-genome route beyond the fused build and the table,
whose JSON must be the JAX ``engine="tpu"`` run's and the host engine's,
journaled or not. Tolerance 0 (integers)."""

import types

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu import pipeline as jax_pipeline
from asgart_tpu import seed as jseed
from asgart_tpu.index import GenomeIndex as JaxGenomeIndex
from asgart_tpu.index import PositionIndex as JaxPositionIndex
from asgart_tpu_torch import pipeline, seed
from asgart_tpu_torch.index import CODE, GenomeIndex, PositionIndex
from asgart_tpu_torch.pipeline import (_pack_probe_kmers, probe_positions,
                                       search_duplications)
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import chunked_genome, jax_settings, json_text, prepared
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import random_dna

CPU = torch.device("cpu")
# tests/test_seed.py's cases, (seed, n, k)
CASES = [(0, 3000, 20), (1, 5000, 12), (2, 2000, 8), (3, 4000, 20)]


def _text(seed_: int, n: int) -> bytes:
    rng = np.random.default_rng(seed_)
    return random_dna(rng, n, b"ACGTN") + b"$"


def _low_complexity() -> bytes:
    """tests/test_seed.py:37's poly-A text: huge equal ranges."""
    rng = np.random.default_rng(9)
    return b"A" * 500 + random_dna(rng, 1000, b"AC") + b"A" * 300 + b"$"


def _probes(text: bytes, k: int, extra: int = 0, rng=None) -> np.ndarray:
    """The packed probes of the text (tests/test_seed.py:27-31), then
    ``extra`` random k-mers (mostly absent from the text)."""
    arr = np.frombuffer(text[:-1], dtype=np.uint8)
    is_ = probe_positions(arr, k)
    codes = np.zeros(len(arr) + k, dtype=np.uint8)
    codes[:len(arr)] = CODE[arr]
    pk = _pack_probe_kmers(codes, is_, k)
    if extra:
        pk = np.concatenate([pk, rng.integers(0, 1 << (3 * k), extra)])
    return pk.astype(np.int64)


def _indexes(text: bytes, k: int):
    arr = np.frombuffer(text, dtype=np.uint8)
    idx = GenomeIndex.build(arr, k)
    jidx = JaxGenomeIndex.build(arr, k)
    np.testing.assert_array_equal(idx.sa, jidx.sa)
    np.testing.assert_array_equal(idx.sa_kmers, jidx.sa_kmers)
    return idx, jidx


def _jax_equal_range(jdsi, pk: np.ndarray, steps: int):
    phi, plo = jseed.split_planes(pk)
    left, right = jseed.equal_range(
        jdsi.key_hi, jdsi.key_lo, jdsi.bucket_starts, jnp.asarray(phi),
        jnp.asarray(plo), steps=steps, prefix_shift=jdsi.prefix_shift)
    return np.asarray(left).astype(np.int64), \
        np.asarray(right).astype(np.int64)


def test_constants_and_split_planes():
    assert (seed.LO_BITS, seed.LO_MASK, seed.DEFAULT_BATCH) == \
        (jseed.LO_BITS, jseed.LO_MASK, jseed.DEFAULT_BATCH)
    pk = np.random.default_rng(1).integers(0, 1 << 60, 1000)
    for a, b in zip(seed.split_planes(pk), jseed.split_planes(pk)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES + ["low_complexity"])
def test_device_seed_index_equals_jax(case):
    """The host arithmetic (prefix bits, shift, bucket table, steps) and
    ``lookup`` against the JAX ``DeviceSeedIndex`` and
    ``GenomeIndex.lookup``; ``equal_range`` itself at the index's depth
    and at depths too small to converge."""
    if case == "low_complexity":
        text, k, batch = _low_complexity(), 10, 128
    else:
        seed_, n, k = case
        text, batch = _text(seed_, n), 256
    idx, jidx = _indexes(text, k)
    dsi = seed.DeviceSeedIndex(idx, CPU, batch=batch)
    jdsi = jseed.DeviceSeedIndex(jidx, batch=batch)
    assert (dsi.prefix_bits, dsi.prefix_shift, dsi.steps) == \
        (jdsi.prefix_bits, jdsi.prefix_shift, jdsi.steps)
    assert np.array_equal(dsi.bucket_starts.numpy(),
                          np.asarray(jdsi.bucket_starts))
    hi, lo = seed.split_planes(dsi.keys.numpy())
    assert np.array_equal(hi, np.asarray(jdsi.key_hi))
    assert np.array_equal(lo, np.asarray(jdsi.key_lo))

    pk = _probes(text, k, 300, np.random.default_rng(7))
    got = dsi.lookup(pk)
    for want in (jdsi.lookup(pk), idx.lookup(pk)):
        for a, b in zip(got, want):
            assert a.dtype == np.int64 and np.array_equal(a, b)
    for steps in sorted({dsi.steps, 1, max(1, dsi.steps // 2)}):
        got = seed.equal_range(dsi.keys, dsi.bucket_starts,
                               torch.from_numpy(pk), steps,
                               dsi.prefix_shift)
        want = _jax_equal_range(jdsi, pk, steps)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), b)
    if case == "low_complexity":  # a bucket wider than the search depth
        assert dsi.steps >= 11
        short = seed.equal_range(dsi.keys, dsi.bucket_starts,
                                 torch.from_numpy(pk), 2, dsi.prefix_shift)
        assert not np.array_equal(short[1].numpy(), idx.lookup(pk)[1])


@pytest.mark.parametrize("k,prefix_bits", [(8, None), (8, 5), (12, 10),
                                           (14, 20), (20, 12), (20, 24)])
def test_prefix_bits_and_clamp_equal_jax(k, prefix_bits):
    """No buckets at k <= 10 (the whole array searched), 6 bits at k =
    12, and explicit prefix bits that the clamp at seed.py:180-181
    lowers (12 -> 6, 14 -> 12) or keeps."""
    text = _text(5, 6000)
    idx, jidx = _indexes(text, k)
    dsi = seed.DeviceSeedIndex(idx, CPU, prefix_bits=prefix_bits, batch=500)
    jdsi = jseed.DeviceSeedIndex(jidx, prefix_bits=prefix_bits, batch=500)
    assert (dsi.prefix_bits, dsi.prefix_shift, dsi.steps) == \
        (jdsi.prefix_bits, jdsi.prefix_shift, jdsi.steps)
    assert np.array_equal(dsi.bucket_starts.numpy(),
                          np.asarray(jdsi.bucket_starts))
    pk = _probes(text, k, 500, np.random.default_rng(k))
    for a, b in zip(dsi.lookup(pk), jdsi.lookup(pk)):
        assert np.array_equal(a, b)
    if k <= 10:
        assert dsi.prefix_shift == -1


def test_value_errors_equal_jax():
    """k > 20, and a suffix array or a range table of 2^31 rows (stubs),
    raise ``ValueError`` in both packages."""
    text = _text(0, 500)
    idx, jidx = _indexes(text, 21)
    with pytest.raises(ValueError, match="probe_size <= 20"):
        seed.DeviceSeedIndex(idx, CPU)
    with pytest.raises(ValueError, match="probe_size <= 20"):
        jseed.DeviceSeedIndex(jidx)

    class Huge:
        def __len__(self):
            return 1 << 31

    stub = types.SimpleNamespace(k=20, sa=Huge(), ranges=Huge())
    for cls in (seed.DeviceSeedIndex, jseed.DeviceSeedIndex):
        with pytest.raises(ValueError, match="too large for int32"):
            cls(stub)
    for cls in (seed.DevicePositionTables, jseed.DevicePositionTables):
        with pytest.raises(ValueError, match="too large for int32"):
            cls(stub)


@pytest.mark.parametrize("k", [20, 12, 8, 1])
def test_pack_probe_planes_equals_jax(k):
    """KS against the JAX ``pack_probe_planes`` and the host pack
    (``_pack_probe_kmers`` + ``split_planes``)."""
    rng = np.random.default_rng(4)
    arr = np.frombuffer(random_dna(rng, 500, b"ACGTN"), dtype=np.uint8)
    is_ = probe_positions(arr, k) if k > 1 else np.arange(len(arr))
    codes = np.zeros(len(arr) + k, dtype=np.uint8)
    codes[:len(arr)] = CODE[arr]
    got = seed.pack_probe_planes(torch.from_numpy(codes),
                                 torch.from_numpy(is_), k)
    want = jseed.pack_probe_planes(jnp.asarray(codes),
                                   jnp.asarray(is_.astype(np.int32)), k)
    host = seed.split_planes(_pack_probe_kmers(codes, is_, k))
    for a, b, c in zip(got, want, host):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(a.numpy(), c)


def test_gathers_equal_jax():
    """KR's two forms against ``_gather_range_rows`` and
    ``_gather_tables``."""
    rng = np.random.default_rng(6)
    n = 5000
    ranges = rng.integers(-2**31, 2**31, (n, 2), dtype=np.int64) \
        .astype(np.int32)
    x = rng.integers(0, n, 20000)
    x[:2] = (0, n - 1)
    t_ranges, t_x = torch.from_numpy(ranges), torch.from_numpy(x)
    rows = np.asarray(jseed._gather_range_rows(
        jnp.asarray(ranges), jnp.asarray(x.astype(np.int32))))
    lo, hi = seed._gather_range_rows(t_ranges, t_x)
    assert lo.dtype == hi.dtype == torch.int64
    assert np.array_equal(lo.numpy(), rows[:, 0])
    assert np.array_equal(hi.numpy(), rows[:, 1])
    pos_lo = np.ascontiguousarray(ranges[:, 0])
    pos_hi = np.ascontiguousarray(ranges[:, 1])
    want = jseed._gather_tables(jnp.asarray(pos_lo), jnp.asarray(pos_hi),
                                jnp.asarray(x.astype(np.int32)))
    got = seed._gather_tables(torch.from_numpy(pos_lo),
                              torch.from_numpy(pos_hi), t_x)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_empty_inputs_and_bounds():
    """No probe, no index, no position: empty outputs (no launch on a
    GPU). An index outside its array raises before any read."""
    keys = torch.arange(10, dtype=torch.int64)
    buckets = torch.tensor([0, 4, 10], dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int64)
    for out in seed.equal_range(keys, buckets, none, 4, 0):
        assert out.shape == (0,) and out.dtype == torch.int64
    rows = torch.zeros((6, 2), dtype=torch.int32)
    for out in seed._gather_range_rows(rows, none):
        assert out.shape == (0,) and out.dtype == torch.int64
    codes = torch.zeros(30, dtype=torch.uint8)
    for out in seed.pack_probe_planes(codes, none, 20):
        assert out.shape == (0,) and out.dtype == torch.int32
    assert seed.DevicePositionTables(
        types.SimpleNamespace(ranges=rows.numpy()), CPU).gather_ranges(
        np.zeros(0, np.int64))[0].shape == (0,)

    with pytest.raises(ValueError, match="outside"):
        seed._gather_range_rows(rows, torch.tensor([6]))
    with pytest.raises(ValueError, match="outside"):
        seed._gather_range_rows(rows, torch.tensor([-1]))
    with pytest.raises(ValueError, match="past the codes"):
        seed.pack_probe_planes(codes, torch.tensor([11]), 20)
    # prefix_shift 0 on a 2-bucket table: keys of 31 bits and more have no
    # bucket
    with pytest.raises(ValueError, match="outside its array"):
        seed.equal_range(keys, buckets, torch.tensor([1 << 31]), 4, 0)
    with pytest.raises(ValueError, match="outside its array"):
        seed.equal_range(keys, torch.tensor([0, 11], dtype=torch.int32),
                         torch.tensor([5]), 4, 0)


# (bucket table, probes, raises): keys 0..9, prefix_shift 0 (bucket p >>
# 30); the table's entries read by no probe are not checked
KQ_BOUNDS = {
    "negative probe": ([0, 4, 10], [3, -1], True),
    "prefix past the table": ([0, 4, 10], [3, 2 << 30], True),
    "prefix at the table's end": ([0, 4, 10], [3, (1 << 30) + 5], False),
    "bound below 0": ([-1, 4, 10], [3], True),
    "bound past N": ([0, 4, 11], [(1 << 30) + 5], True),
    "bounds crossed": ([0, 5, 4, 10], [(1 << 30) + 1], True),
    "unread bad bound": ([0, 4, 10, 99], [3, (1 << 30) + 5], False),
    "unread crossed bounds": ([0, 5, 4, 10], [3, (2 << 30) + 9], False),
}


@pytest.mark.parametrize("case", sorted(KQ_BOUNDS))
def test_equal_range_bounds_on_cpu(case):
    """KQ's check on the CPU path, per probe as the kernel makes it on the
    card: a probe that is negative, whose prefix lies past the bucket
    table, or whose bucket's bounds do not satisfy 0 <= lo0 <= hi0 <= N
    raises ``ValueError``; bounds no probe reads are not checked, and the
    probes that pass get the JAX result."""
    table, probes, raises = KQ_BOUNDS[case]
    keys = torch.arange(10, dtype=torch.int64)
    buckets = torch.tensor(table, dtype=torch.int32)
    pk = torch.tensor(probes, dtype=torch.int64)
    if raises:
        with pytest.raises(ValueError, match="outside its array"):
            seed.equal_range(keys, buckets, pk, 4, 0)
        return
    got = seed.equal_range(keys, buckets, pk, 4, 0)
    jkeys = np.arange(10, dtype=np.int64)
    want = jseed.equal_range(
        *(jnp.asarray(a) for a in seed.split_planes(jkeys)),
        jnp.asarray(np.array(table, dtype=np.int32)),
        *(jnp.asarray(a) for a in seed.split_planes(np.array(probes))),
        steps=4, prefix_shift=0)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_equal_range_without_buckets_checks_nothing():
    """Without buckets (prefix_shift < 0) every probe searches all N rows:
    a negative probe reads no table and gets an empty range at 0, as the
    JAX loop gives it."""
    keys = torch.arange(10, dtype=torch.int64)
    lo, hi = seed.equal_range(keys, torch.zeros(0, dtype=torch.int32),
                              torch.tensor([-5, 3, 10]), 4, -1)
    assert lo.tolist() == [0, 3, 10] and hi.tolist() == [0, 4, 10]


def test_equal_range_reads_needs_the_card():
    """KQ counts its key reads in the kernel: on CPU tensors there is no
    count to read, so ``equal_range_reads`` raises."""
    from asgart_tpu_torch.kernels.seed import equal_range_reads

    with pytest.raises(ValueError, match="on the card only"):
        equal_range_reads(torch.arange(10, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.int32),
                          torch.tensor([3]), 4, -1)


@pytest.mark.parametrize("form", ["rows", "planar"])
@pytest.mark.parametrize("bad", [-1, -(1 << 40), 6, 1 << 40])
def test_gather_ranges_outside_raises_on_cpu(form, bad):
    """KR's host check on the CPU path, in both forms: an index outside
    [0, n), negative ones included (torch's CPU indexing would wrap them),
    raises; an index inside it does not."""
    rows = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    src = ((rows[:, 0], rows[:, 1]) if form == "rows"
           else (rows[:, 0].contiguous(), rows[:, 1].contiguous()))
    x = torch.tensor([0, 5, bad, 3])
    with pytest.raises(ValueError, match="outside"):
        seed.gather_ranges(*src, x)
    lo, hi = seed.gather_ranges(*src, x[[0, 1, 3]])
    assert lo.tolist() == [0, 10, 6] and hi.tolist() == [1, 11, 7]


@pytest.mark.parametrize("rc", [False, True])
def test_position_tables_equal_jax(rc):
    """``DevicePositionTables.gather_ranges`` on a doubled-text
    ``PositionIndex`` (small batches) against the JAX one."""
    text = np.frombuffer(_text(8, 4000), dtype=np.uint8)
    pidx = PositionIndex.build(text, 21, reverse=rc, complement=rc)
    jpidx = JaxPositionIndex.build(text, 21, reverse=rc, complement=rc)
    assert np.array_equal(pidx.ranges, jpidx.ranges)
    x = pidx.probe_table_positions(0, len(text) - 1,
                                   probe_positions(text[:-1], 21))
    got = seed.DevicePositionTables(pidx, CPU, batch=97).gather_ranges(x)
    want = jseed.DevicePositionTables(jpidx, batch=97).gather_ranges(x)
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)


def _run_chunks(engine, chunks) -> list:
    return [[[vars(sd) for sd in fam] for fam in engine.run_chunk(c)]
            for c in chunks]


@pytest.mark.parametrize("k,trim", [(20, (12000, 52000)), (20, None),
                                    (21, None)])
@pytest.mark.parametrize("rc", [False, True])
def test_search_engine_equals_jax_tpu(tmp_path, k, trim, rc):
    """``SearchEngine(engine="cuda", device=cpu).run_chunk``, chunk by
    chunk, against the JAX ``SearchEngine(engine="tpu")``: a trim window
    (``DeviceSeedIndex``) and the whole genome (``DevicePositionTables``)."""
    from asgart_tpu.fasta import prepare_data as jax_prepare

    fa, _, _ = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(probe_size=k, trim=trim, reverse=rc, complement=rc)
    _, chunks, strand = pipeline.prepare_data([fa], False, trim)
    _, jchunks, jstrand = jax_prepare([fa], False, trim)
    assert [tuple(c) for c in chunks] == [tuple(c) for c in jchunks]
    se = pipeline.SearchEngine(strand, s, trim, engine="cuda", device=CPU)
    jse = jax_pipeline.SearchEngine(jstrand, jax_settings(s), trim,
                                    engine="tpu")
    want = seed.DeviceSeedIndex if trim else seed.DevicePositionTables
    assert type(se._device) is want
    got = _run_chunks(se, chunks)
    assert got == _run_chunks(jse, jchunks)
    assert any(got) or not rc


def _k21_route(fa: str, s: RunSettings, checkpoint=None) -> str:
    return json_text(search_duplications([fa], s, engine="cuda", device=CPU,
                                         checkpoint=checkpoint))


@pytest.mark.parametrize("rc", [False, True])
def test_k21_route_beyond_fused_and_table(tmp_path, monkeypatch, rc):
    """k = 21, the whole genome beyond the fused build and the table: the
    port's ``SearchEngine`` route writes the JAX ``engine="tpu"`` run's
    bytes (its ``DevicePositionTables`` route) and the host engine's,
    without and with a journal (cold, then resumed); the port used to
    raise here."""
    import asgart_tpu.device_engine as jde
    import asgart_tpu.device_index as jdi

    fa, _, _ = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(probe_size=21, reverse=rc, complement=rc)
    host = json_text(search_duplications([fa], s, engine="host"))
    no = lambda *a, **kw: False  # noqa: E731
    monkeypatch.setattr(jde, "fused_applicable", no)
    monkeypatch.setattr(jdi, "device_index_fits", no)
    built = []
    monkeypatch.setattr(jseed.DevicePositionTables, "__init__",
                        _spy(jseed.DevicePositionTables.__init__, built))
    jtpu = json_text(jax_pipeline.search_duplications(
        [fa], jax_settings(s), engine="tpu"))
    assert built, "the JAX run did not take its device position tables"
    assert jtpu == host

    monkeypatch.setattr(pipeline, "fits", no)
    monkeypatch.setattr(pipeline, "table_fits", no)
    ported = []
    monkeypatch.setattr(seed.DevicePositionTables, "__init__",
                        _spy(seed.DevicePositionTables.__init__, ported))
    assert _k21_route(fa, s) == host
    ck = str(tmp_path / "k21.journal")
    assert _k21_route(fa, s, ck) == host
    assert len(ported) == 2
    assert _k21_route(fa, s, ck) == host  # every chunk restored
    assert len(ported) == 3
    if rc:  # the journal of either package resumes in the other
        assert json_text(jax_pipeline.search_duplications(
            [fa], jax_settings(s), engine="tpu", checkpoint=ck)) == host


def _spy(init, calls: list):
    def spied(self, *a, **kw):
        calls.append(a)
        init(self, *a, **kw)
    return spied


def test_k21_past_int32_addressing_refuses(tmp_path, monkeypatch):
    """Past int32 probe addressing the JAX k = 21 run raises in
    ``DevicePositionTables`` (test_value_errors_equal_jax); the port
    refuses up front and says so, journaled or not (``BIG_WINDOW_SPAN``
    lowered to 0 to reach the route at this size)."""
    fa, _, _ = prepared(tmp_path, [("chr1", chunked_genome())])
    monkeypatch.setattr(pipeline, "BIG_WINDOW_SPAN", 0)
    for ck in (None, str(tmp_path / "j")):
        with pytest.raises(NotImplementedError,
                           match="raises ValueError in DevicePositionTables"):
            _k21_route(fa, RunSettings(probe_size=21, reverse=True,
                                       complement=True), ck)


def test_search_engine_cuda_needs_a_device(tmp_path, monkeypatch):
    """Without CUDA, ``SearchEngine(engine="cuda")`` with no device given
    raises, on a trim window and on the whole genome: no quiet host
    lookup."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa, _, _ = prepared(tmp_path, [("chr1", chunked_genome())])
    for k, trim in ((20, (12000, 52000)), (21, None)):
        _, _, strand = pipeline.prepare_data([fa], False, trim)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.SearchEngine(strand, RunSettings(probe_size=k,
                                                      trim=trim), trim,
                                  engine="cuda")
