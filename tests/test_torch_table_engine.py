"""The table engine's scan front: KM ``table_ranges`` (plain version)
against the front of the JAX ``_scan_chunk`` (asgart_tpu/device_engine.py:
202-238: ``_probe_x0``, ``_dec_read`` and the N-probe and lane masks) on
the tables of a JAX ``DeviceIndex``, for every transform; its exact
per-chunk totals against the cap pre-passes ``_raw_total`` and
``_raw_totals_batch`` (which do not mask N probes); and the port's
``TableEngine`` over a JAX-built index carried across with
``convert.table_index_from_numpy``, whose JSON must be the JAX host
engine's. Exact (integers; tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch.convert import table_index_from_numpy
from asgart_tpu_torch.device_engine import TableEngine, chunk_specs
from asgart_tpu_torch.kernels import table_ranges
from asgart_tpu_torch.pipeline import (_finalize_result,
                                       raw_families_to_protosds)
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import (TRANSFORMS, chunked_genome, jax_settings,
                           json_text, prepared)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

CPU = torch.device("cpu")


def _jax_index(strand, s):
    from asgart_tpu.device_index import DeviceIndex as JaxDeviceIndex

    return JaxDeviceIndex.build(strand.data, s.probe_size,
                                reverse=s.reverse, complement=s.complement)


def _port_index(ref, s):
    return table_index_from_numpy(
        np.asarray(ref.sa), np.asarray(ref.pos_lo), np.asarray(ref.pos_hi),
        ref.k, ref.n, ref.first_len, s.reverse, s.complement, CPU)


@pytest.mark.parametrize("k", [20, 25])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_table_ranges_equal_jax_scan_front(tmp_path, reverse, complement,
                                           k):
    from asgart_tpu import device_engine as de

    _, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    ref = _jax_index(strand, s)
    idx = _port_index(ref, s)
    specs = chunk_specs(chunks, s)
    n1, step = len(strand.data), k // 2
    lane_lo, lane_hi, mask, totals, lane_off = table_ranges(
        idx.pos_lo, idx.pos_hi, specs, n1, k, reverse, complement)
    assert lane_off[-1] == lane_lo.numel() == sum(nc for *_, nc in specs)
    n_flagged = 0
    for c, (cs, cl, nc) in enumerate(specs):
        b_pad = de._bucket(nc)
        x0 = de._probe_x0(jnp.int32(cs), jnp.int32(cl), n1, k, reverse,
                          complement)
        lo_raw = np.asarray(de._dec_read(ref.pos_lo, x0, b_pad, step))
        hi = np.asarray(de._dec_read(ref.pos_hi, x0, b_pad, step))
        j = np.arange(b_pad)
        want_mask = (j * step < cl - k - step) & (lo_raw >= 0)
        want_lo = np.where(want_mask, lo_raw & 0x7FFFFFFF, 0)
        want_hi = np.where(want_mask, hi, 0)
        lanes = slice(lane_off[c], lane_off[c + 1])
        assert not want_mask[nc:].any()
        assert np.array_equal(mask[lanes].numpy(), want_mask[:nc])
        assert np.array_equal(lane_lo[lanes].numpy(), want_lo[:nc])
        assert np.array_equal(lane_hi[lanes].numpy(), want_hi[:nc])
        # the exact total against the float pre-pass, which counts the
        # N probes' windows too
        live = j * step < cl - k - step
        n_lanes = live & (lo_raw < 0)
        n_flagged += int(n_lanes.sum())
        n_windows = int(np.where(n_lanes, hi - (lo_raw & 0x7FFFFFFF),
                                 0).sum())
        raw = float(de._raw_total(ref.pos_lo, ref.pos_hi, jnp.int32(cs),
                                  jnp.int32(cl), jnp.int32(n1), k, reverse,
                                  complement, b_pad))
        assert int(totals[c]) + n_windows == raw
    assert n_flagged > 0  # the genome's in-chunk N probes
    same = [c for c, (_, _, nc) in enumerate(specs)
            if de._bucket(nc) == de._bucket(specs[0][2])]
    batch = np.asarray(de._raw_totals_batch(
        ref.pos_lo, ref.pos_hi,
        jnp.asarray(np.array([specs[c][:2] for c in same], np.int32)),
        jnp.int32(n1), k, reverse, complement, de._bucket(specs[0][2])))
    assert batch.tolist() == [float(de._raw_total(
        ref.pos_lo, ref.pos_hi, jnp.int32(specs[c][0]),
        jnp.int32(specs[c][1]), jnp.int32(n1), k, reverse, complement,
        de._bucket(specs[0][2]))) for c in same]


@pytest.mark.parametrize("reverse,complement", [(True, True),
                                                (False, False)])
def test_table_engine_on_jax_index(tmp_path, reverse, complement):
    """A JAX-built DeviceIndex drives the port's TableEngine (KM, KD and
    the native chain) to the JAX host engine's JSON, chunk by chunk as a
    journal runs it and all chunks at once."""
    fa, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(reverse=reverse, complement=complement)
    eng = TableEngine(strand, s, CPU, cache=None,
                      index=_port_index(_jax_index(strand, s), s))
    host = json_text(jax_search([fa], jax_settings(s), engine="host"))
    for raws in (eng.run_chunks(chunks),
                 [eng.run_chunk(c) for c in chunks]):
        fams = []
        for (start, length), raw in zip(chunks, raws):
            fams.extend(raw_families_to_protosds(raw, s, start, length))
        assert json_text(_finalize_result(fams, strand, s)) == host
