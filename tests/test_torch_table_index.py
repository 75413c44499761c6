"""The table index (asgart_tpu_torch/table_index.py) and the plain versions
of its kernels against the JAX table build they replace
(asgart_tpu/device_index.py:1140-1245), step by step on the CPU: KA's
doubled mode against ``_build_text_codes`` + ``_pack_planes_all`` /
``_pack_planes3_all`` with the appended flag; KB's N-probe flag and run
ends against ``_group_bounds_impl(flag_n_k=k)``; KJ ``invert_tables``
against ``_invert_tables_dec`` (its planes re-laid at C = ceil(n / step),
its rank seed in position order); KK / KL, one full round,
against ``_full_round``; and the whole ``DeviceIndex.build`` (``sa`` with
the appended half's order, and the tables with their N flag) against the
JAX ``DeviceIndex.build`` for every transform at k = 12, 20 and 25, with
the default and a small ``tied_cap``, plus the cases of
tests/test_device_index.py:68-117. Exact (integers; tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu_torch.convert import (rank_from_decimated,
                                      relaid_decimated,
                                      table_index_from_numpy)
from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.kernels import (full_round_keys, full_round_refine,
                                      group_bounds, invert_tables, pack_keys)
from asgart_tpu_torch.table_index import DeviceIndex

from torch_jax_ref import TRANSFORMS, fused_key
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import random_dna, revcomp

CPU = torch.device("cpu")


def _text(seed: int = 21, n: int = 3000) -> np.ndarray:
    """Genome + '$' with an identical direct copy, an identical RC copy
    (deep ties in every transform) and N probes inside the text."""
    rng = np.random.default_rng(seed)
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[1500:2100] = bytes(g[100:700])
    g[2300:2900] = revcomp(bytes(g[100:700]))
    g[50:53] = b"NNN"
    g[1700] = ord("N")
    return np.frombuffer(bytes(g) + b"$", dtype=np.uint8)


def _jax_stages(data: np.ndarray, k: int, reverse: bool, complement: bool):
    """The JAX table build's intermediates as numpy, as DeviceIndex.build
    runs them (device_index.py:1177-1240)."""
    from asgart_tpu import device_engine as de
    from asgart_tpu import device_index as di

    n1 = len(data)
    doubled = reverse or complement
    n = 2 * n1 - 1 if doubled else n1
    L = de.table_len_for(n, k)
    text = di._build_text_codes(jnp.asarray(CODE[data]), k, reverse,
                                complement, L)
    out = {"n": n, "n1": n1, "L": L}
    if k > di.DEVICE_MAX_K:
        top, hi, lo = di._pack_planes3_all(text, k, n)
        out["planes"] = [np.asarray(p) for p in (top, hi, lo)]
        if doubled:
            sktop, skhi, sklo, sa = di._flagged_sort3(top, hi, lo,
                                                      jnp.int32(n1))
        else:
            sktop, skhi, sklo, sa = di._initial_sort3(top, hi, lo)
    else:
        hi, lo = di._pack_planes_all(text, k, n)
        out["planes"] = [np.asarray(p) for p in (hi, lo)]
        if doubled:
            skhi, sklo, sa = di._flagged_sort(hi, lo, jnp.int32(n1))
        else:
            skhi, sklo, sa = di._initial_sort(hi, lo)
        sktop = None
    out["sorted"] = [np.asarray(p) for p in (sktop, skhi, sklo)
                     if p is not None]
    out["sa"] = np.asarray(sa)
    run_lo, run_hi, tied = di._group_bounds_impl(
        skhi, sklo, sa, jnp.int32(n1), flagged=doubled, flag_n_k=k,
        sktop=sktop)
    out.update(run_lo=np.asarray(run_lo), run_hi=np.asarray(run_hi),
               tied=np.asarray(tied))
    pos_lo, pos_hi, rank = di._invert_tables_dec(sa, run_lo, run_hi,
                                                 k // 2, L)
    out.update(pos_lo=np.asarray(pos_lo), pos_hi=np.asarray(pos_hi),
               rank=np.asarray(rank))
    return out


def _port_words(planes, flag):
    """The port's key words of JAX planes and a flag per row: one int64
    (hi << 31) | (lo << 1) | flag, or (top << 31) | hi and (lo << 1) |
    flag."""
    if len(planes) == 2:
        hi, lo = planes
        return [torch.from_numpy(
            (hi.astype(np.int64) << 31) | (lo.astype(np.int64) << 1) | flag)]
    top, hi, lo = planes
    return [torch.from_numpy((top.astype(np.int64) << 31) | hi),
            torch.from_numpy(((lo.astype(np.int64) << 1) | flag)
                             .astype(np.int32))]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [12, 20, 25])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_build_stages_equal_jax(reverse, complement, k):
    """KA (doubled mode), KB (N flag, run ends) and KJ on the JAX build's
    own inputs: keys, slot bounds and the undecimated tables."""
    data = _text()
    ref = _jax_stages(data, k, reverse, complement)
    n, n1 = ref["n"], ref["n1"]
    doubled = reverse or complement
    flag = (np.arange(n) >= n1).astype(np.int64) if doubled else 0
    codes = torch.from_numpy(CODE[data])
    keys, _ = pack_keys(codes, (), k, reverse, complement, n, 0,
                        doubled=doubled)
    for got, want in zip(keys, _port_words(ref["planes"], flag)):
        assert torch.equal(got, want)
    if len(ref["planes"]) == 2:  # the JAX fused build's key helper agrees
        assert np.array_equal(keys[0].numpy(), fused_key(
            *ref["planes"], n1 if doubled else n))

    sorted_flag = (ref["sorted"][-1] & 1) if doubled else 0
    sorted_planes = ref["sorted"][:-1] + [ref["sorted"][-1] >> 1] \
        if doubled else ref["sorted"]
    skeys = _port_words(sorted_planes, sorted_flag)
    sa = _t(ref["sa"])
    run_lo, run_hi, tied = group_bounds(skeys, sa, n1, flag_n_k=k,
                                        run_end=not doubled)
    assert torch.equal(run_lo, _t(ref["run_lo"]))
    assert torch.equal(run_hi, _t(ref["run_hi"]))
    assert torch.equal(tied, _t(ref["tied"]))
    assert (run_lo < 0).any()  # the N probes are flagged

    step = k // 2
    pos_lo, pos_hi, rank = invert_tables(sa, run_lo, run_hi, step)
    # the planes in the JAX decimated layout, re-laid at C = ceil(n /
    # step) columns; the rank seed in position order
    for got, want in ((pos_lo, ref["pos_lo"]), (pos_hi, ref["pos_hi"])):
        assert np.array_equal(got.numpy(), relaid_decimated(want, step, n))
    assert np.array_equal(rank.numpy(), rank_from_decimated(ref["rank"],
                                                            step, n))


@pytest.mark.parametrize("doubled", [False, True])
def test_full_round_equals_jax(doubled):
    """KK, the stable sort and KL against one ``_full_round`` over every
    row, flagged (-RC: the appended flag orders each group's rows) and
    unflagged, from the build's first tied state, then from the second
    round's."""
    from asgart_tpu import device_index as di

    k = 12
    data = _text()
    rc = (True, True) if doubled else (False, False)
    ref = _jax_stages(data, k, *rc)
    n, n1 = ref["n"], ref["n1"]
    rank0 = rank_from_decimated(ref["rank"], k // 2, n).astype(np.int32)
    jsa, jrank = jnp.asarray(ref["sa"]), jnp.asarray(rank0)
    sa, rank = _t(ref["sa"]), torch.from_numpy(rank0.copy())
    h = k
    for _ in range(2):
        jsa, jrank, jtied = di._full_round(jsa, jrank, jnp.int32(h),
                                           jnp.int32(n1))
        key = full_round_keys(rank, h, n1)
        skey, order = torch.sort(key, stable=True)
        sa, tied = full_round_refine(skey, order, rank, n1)
        assert np.array_equal(sa.numpy(), np.asarray(jsa))
        assert np.array_equal(rank.numpy(), np.asarray(jrank))
        assert np.array_equal(tied.numpy(), np.asarray(jtied))
        assert tied.any()
        h *= 2


def _assert_index_equal(data, k, reverse, complement, tied_cap=None):
    from asgart_tpu.device_index import DeviceIndex as JaxDeviceIndex

    jd = JaxDeviceIndex.build(data, k, reverse=reverse,
                              complement=complement, tied_cap=tied_cap)
    pd = DeviceIndex.build(data, k, reverse, complement, CPU,
                           tied_cap=tied_cap)
    jsa, jranges = jd.to_host_arrays()
    psa, pranges = pd.to_host_arrays()
    assert np.array_equal(psa, jsa)  # the appended rows' order too
    assert np.array_equal(pranges, jranges)
    # the N flag in pos_lo's sign bit, through the converter
    conv = table_index_from_numpy(jd.sa, jd.pos_lo, jd.pos_hi, k, jd.n,
                                  jd.first_len, reverse, complement, CPU)
    for got, want in ((pd.pos_lo, conv.pos_lo), (pd.pos_hi, conv.pos_hi),
                      (pd.sa, conv.sa)):
        assert torch.equal(got, want)
    return pd


@pytest.mark.parametrize("tied_cap", [None, 64])
@pytest.mark.parametrize("k", [12, 20, 25])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_device_index_equals_jax(reverse, complement, k, tied_cap):
    pd = _assert_index_equal(_text(), k, reverse, complement, tied_cap)
    assert (pd.pos_lo < 0).any()


def test_device_index_doubled_deep_ties():
    """tests/test_device_index.py:68's text: identical direct and RC
    copies, -RC at k = 12, subset rounds alone and (tied_cap = 64) after
    flagged full rounds."""
    rng = np.random.default_rng(21)
    g = bytearray(random_dna(rng, 6000, b"ACGT"))
    g[2500:3700] = bytes(g[200:1400])
    g[4500:5700] = revcomp(bytes(g[200:1400]))
    data = np.frombuffer(bytes(g) + b"$", dtype=np.uint8)
    for cap in (None, 64):
        _assert_index_equal(data, 12, True, True, cap)


def test_device_index_hyper_repetitive_full_rounds():
    """tests/test_device_index.py:99's text: a 40-mer repeated 50 times,
    direct and -RC, full rounds (tied_cap = 64) down to every tie."""
    rng = np.random.default_rng(6)
    base = random_dna(rng, 40, b"ACGT")
    text = base * 50 + random_dna(rng, 500, b"ACGT") + b"$"
    data = np.frombuffer(text, dtype=np.uint8)
    for rc in ((False, False), (True, True)):
        _assert_index_equal(data, 8, *rc, tied_cap=64)


def test_device_index_all_same_symbol():
    """tests/test_device_index.py:111: one symbol throughout, every row
    tied until the last round."""
    data = np.frombuffer(b"A" * 2000 + b"$", dtype=np.uint8)
    for rc in ((False, False), (True, True)):
        _assert_index_equal(data, 10, *rc, tied_cap=128)


def test_table_bounds_refused():
    from asgart_tpu_torch.fused_index import table_fits_bytes

    data = _text()
    with pytest.raises(ValueError, match="probe_size"):
        DeviceIndex.build(data, 31, True, True, CPU)
    assert table_fits_bytes(2**30, 20, True, float("inf"))
    assert not table_fits_bytes(2**30 + 1, 20, True, float("inf"))
    assert table_fits_bytes(2**31 - 1, 20, False, float("inf"))
    assert not table_fits_bytes(1000, 31, False, float("inf"))
