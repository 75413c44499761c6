"""The merge-join window index and join against the JAX ones: KA's
probe-only mode (plain version) against ``_pack_batch_probe_keys``, KA's
window keys with no probe rows against ``_pack_planes_all`` over
``_window_codes``, KB against ``_group_bounds_impl(flagged=False)``, KC with
no lanes against ``_invert_perm``, the whole ``DeviceWindowIndex.build``
against JAX's (sorted key planes and ``sa``), and KH's plain version
against ``_mj_tail`` and ``_mj_ranges_from_keys``. Exact (integers;
tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu import device_engine as de
from asgart_tpu import device_index as di
from asgart_tpu_torch.device_engine import chunk_specs
from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.kernels import (group_bounds, invert_fused, mj_ranges,
                                      pack_keys)
from asgart_tpu_torch.kernels.pack_keys import LO_CLAMP, PAD_KEY
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.window_index import (DeviceWindowIndex,
                                           window_arrays_from_codes)

from torch_jax_ref import (TRANSFORMS, chunked_genome, masked_multifasta,
                           prepared, vocab_genome)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

CPU = torch.device("cpu")
PLANE_PAD = 2**31 - 1  # the JAX probe pad of every plane

# (genome, window): the chunked genome (60000 bp; N run 12000-18000, N
# probes 30000-30100), the two-record genome and the tied vocabulary
WINDOWS = {
    "start": ("chunked", (0, 21000)),
    "end": ("chunked", (38000, 60000)),
    "n_run": ("chunked", (9000, 33000)),
    "fragments": ("multifasta", (17000, 39000)),
    "vocab": ("vocab", (15000, 60000)),
}


def _strand(tmp_path, genome):
    records = {"chunked": lambda: [("chr1", chunked_genome())],
               "multifasta": masked_multifasta,
               "vocab": lambda: [("chr1", vocab_genome())]}[genome]()
    _, chunks, strand = prepared(tmp_path, records)
    return chunks, strand


def _port_key(hi, lo) -> np.ndarray:
    """JAX (hi, lo) planes as the port's one-word key with flag 0."""
    return (np.asarray(hi).astype(np.int64) << 31) \
        | (np.asarray(lo).astype(np.int64) << 1)


@pytest.mark.parametrize("k", [8, 20])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_probe_only_keys_equal_jax(tmp_path, reverse, complement, k):
    """KA with W = 0 against the JAX window engine's probe side: its
    decimated doubled codes (``_shared_decimated_codes``) packed by
    ``_pack_batch_probe_keys``, 16 pad lanes past the chunks' lanes."""
    chunks, strand = _strand(tmp_path, "chunked")
    specs = chunk_specs(chunks, RunSettings(reverse=reverse,
                                            complement=complement,
                                            probe_size=k))
    n1 = len(strand.data)
    n = 2 * n1 - 1 if (reverse or complement) else n1
    total = sum(nc for (_, _, nc) in specs) + 16
    dec = di._shared_decimated_codes(jnp.asarray(CODE[strand.data]),
                                     strand.data, k, reverse, complement, n)
    phi, plo, mask = (np.asarray(a) for a in de._pack_batch_probe_keys(
        dec, jnp.zeros(len(specs), jnp.int32), k, reverse, complement, n1,
        specs, total))
    (key,), lane_mask = pack_keys(torch.from_numpy(CODE[strand.data]), specs,
                                  k, reverse, complement, 0, total)
    key = key.numpy()
    live = phi != PLANE_PAD
    assert live.sum() == total - 16
    assert np.array_equal(key[live] >> 31, phi[live])
    assert np.array_equal((key[live] >> 1) & LO_CLAMP, plo[live])
    assert np.all(key & 1 == 1)
    assert np.all(key[~live] == PAD_KEY)
    assert np.array_equal(lane_mask.numpy(), mask)
    assert mask.any() and not mask.all()


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("k", [8, 20])
def test_window_stages_equal_jax(tmp_path, k, window):
    """KA with no probe rows, KB, KC with no lanes and the window build's
    final arrays, stage by stage against ``window_arrays_from_codes``:
    KA against ``_pack_planes_all`` over ``_window_codes``, the stable
    sort against ``_initial_sort``, KB against ``_group_bounds_impl``
    unflagged (every row is direct and the flag 0, so KB's run_lo and
    tied are its unflagged outputs), KC against ``_invert_perm``."""
    genome, (ws, we) = WINDOWS[window]
    _, strand = _strand(tmp_path, genome)
    W = we - ws + 1
    codes1 = jnp.asarray(CODE[strand.data])
    win_codes = di._window_codes(codes1, jnp.int32(ws), W - 1, k)
    hi, lo = di._pack_planes_all(win_codes, k, W)
    want_key = _port_key(hi, lo)
    skhi, sklo, sa = di._initial_sort(hi, lo)  # donates hi, lo
    run_lo, _, tied = di._group_bounds_impl(skhi, sklo, sa, jnp.int32(W))
    rank = di._invert_perm(sa, run_lo)

    codes = torch.from_numpy(CODE[strand.data])
    (key,), mask = pack_keys(codes, (), k, False, False, W, 0, ws)
    assert mask.numel() == 0
    assert np.array_equal(key.numpy(), want_key)
    skey, order = torch.sort(key, stable=True)
    sa_p = order.to(torch.int32)
    assert np.array_equal(skey.numpy(), _port_key(skhi, sklo))
    assert np.array_equal(sa_p.numpy(), np.asarray(sa))
    got_lo, got_hi, got_tied = group_bounds([skey], sa_p, W)
    assert np.array_equal(got_lo.numpy(), np.asarray(run_lo))
    assert np.array_equal(got_hi.numpy(), np.asarray(run_lo))
    assert np.array_equal(got_tied.numpy(), np.asarray(tied))
    got_rank, lane_lo, lane_hi, totals = invert_fused(
        sa_p, got_lo, got_hi, mask, W, [0])
    assert np.array_equal(got_rank.numpy(), np.asarray(rank))
    assert lane_lo.numel() == lane_hi.numel() == totals.numel() == 0

    ref_hi, ref_lo, _, ref_sa = di.window_arrays_from_codes(win_codes, k, W)
    got_key, got_sa = window_arrays_from_codes(codes, k, W, ws)
    assert np.array_equal(got_key.numpy(), _port_key(ref_hi, ref_lo))
    assert np.array_equal(got_sa.numpy(), np.asarray(ref_sa))


def _assert_index_equal(strand, k, trim, reverse, complement):
    ref = di.DeviceWindowIndex.build(strand.data, k, trim=trim,
                                     reverse=reverse, complement=complement)
    got = DeviceWindowIndex.build(strand.data, k, trim, reverse, complement,
                                  CPU)
    assert np.array_equal(got.key.numpy(), _port_key(ref.key_hi, ref.key_lo))
    assert np.array_equal(got.sa.numpy(), np.asarray(ref.sa))
    assert (got.W, got.n, got.first_len, got.win_start, got.win_end) == \
        (ref.W, ref.n, ref.first_len, ref.win_start, ref.win_end)
    return got


@pytest.mark.parametrize("k", [8, 20])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_window_index_equals_jax_transforms(tmp_path, reverse, complement,
                                            k):
    """A middle window for each transform: its suffix order holds genome
    positions (KG) and only positions inside the window."""
    _, strand = _strand(tmp_path, "chunked")
    got = _assert_index_equal(strand, k, (19000, 46000), reverse, complement)
    assert np.array_equal(np.sort(got.sa.numpy()), np.arange(19000, 46001))


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_window_index_equals_jax_windows(tmp_path, window):
    genome, trim = WINDOWS[window]
    _, strand = _strand(tmp_path, genome)
    _assert_index_equal(strand, 20, trim, True, True)


def test_window_index_refuses(tmp_path):
    _, strand = _strand(tmp_path, "chunked")
    n1 = len(strand.data)
    for trim in ((5, 5), (10, 2), (-1, 100), (0, n1)):
        with pytest.raises(ValueError, match="bad trim window"):
            DeviceWindowIndex.build(strand.data, 20, trim, True, True, CPU)
    with pytest.raises(ValueError, match="probe_size 2..20"):
        DeviceWindowIndex.build(strand.data, 21, (0, 100), True, True, CPU)


def _join_case(seed: int, W: int, n_live: int, pad: int, alphabet: int):
    """Sorted window planes of W random k-mers over ``alphabet`` symbols
    (a small alphabet makes long repeat runs), and probe planes: window
    keys, keys absent from the window, the first and the last slot's key,
    JAX pad lanes; a random mask (pad lanes masked)."""
    rng = np.random.default_rng(seed)
    k = 20
    sym = rng.integers(1, 1 + alphabet, (W, k))
    sym[-50:] = sym[7]  # a run of at least 51 equal keys
    weights = 8 ** np.arange(9, -1, -1)
    hi = (sym[:, :10] * weights).sum(1).astype(np.int32)
    lo = (sym[:, 10:] * weights).sum(1).astype(np.int32)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    pick = rng.integers(0, W, n_live)
    phi, plo = hi[pick].copy(), lo[pick].copy()
    absent = rng.random(n_live) < 0.3
    phi[absent] = rng.integers(0, 2**30, absent.sum())  # almost surely new
    phi[:4] = [hi[0], hi[-1], hi[0], 0]
    plo[:4] = [lo[0], lo[-1], lo[0] + 1, 0]  # first, last, absent, least
    mask = rng.random(n_live) < 0.8
    phi = np.concatenate([phi, np.full(pad, PLANE_PAD, np.int32)])
    plo = np.concatenate([plo, np.full(pad, PLANE_PAD, np.int32)])
    mask = np.concatenate([mask, np.zeros(pad, bool)])
    mask[:3] = True
    return hi, lo, phi.astype(np.int32), plo.astype(np.int32), mask


def _port_probe_key(phi, plo):
    """JAX probe planes as KA's probe-only key (lo clamped, flag 1)."""
    key = (phi.astype(np.int64) << 31) \
        | (np.minimum(plo, LO_CLAMP).astype(np.int64) << 1) | 1
    return np.where(phi == PLANE_PAD, PAD_KEY, key)


@pytest.mark.parametrize("seed,W,n_live,pad,alphabet", [
    (1, 5000, 3000, 64, 4),     # random window, few repeats
    (2, 4000, 2500, 0, 1),      # one k-mer: a single run the whole window
    (3, 6000, 4000, 37, 2),     # repeat-heavy window
])
def test_mj_ranges_plain_equals_jax(seed, W, n_live, pad, alphabet):
    """KH's plain version against ``_mj_tail`` and ``_mj_ranges_from_keys``
    (three chunks' lanes back to back, then pad lanes): absent keys, runs
    at the window's first and last slot, masked and pad lanes, a
    repeat-heavy window."""
    hi, lo, phi, plo, mask = _join_case(seed, W, n_live, pad, alphabet)
    specs = ((0, 1, n_live // 3), (1, 1, n_live // 3),
             (2, 1, n_live - 2 * (n_live // 3)))
    lane_off = [0, n_live // 3, 2 * (n_live // 3), n_live]
    j = [jnp.asarray(a) for a in (hi, lo, phi, plo, mask)]
    want_lo, want_hi = (np.asarray(a) for a in de._mj_tail(*j))
    r_lo, r_hi, r_mask, r_tot = (np.asarray(a) for a in
                                 de._mj_ranges_from_keys(*j, specs=specs))
    assert np.array_equal(r_lo, want_lo) and np.array_equal(r_hi, want_hi)
    got_lo, got_hi, totals = mj_ranges(
        torch.from_numpy(_port_key(hi, lo)),
        torch.from_numpy(_port_probe_key(phi, plo)),
        torch.from_numpy(mask), lane_off)
    assert np.array_equal(got_lo.numpy(), want_lo)
    assert np.array_equal(got_hi.numpy(), want_hi)
    assert np.array_equal(totals.numpy(), r_tot.astype(np.int64))
    # the cases are not vacuous: absent (empty) and present ranges, runs
    # at both ends of the window
    assert ((want_hi == want_lo) & mask).any()
    assert (want_hi - want_lo > 1).any()
    assert want_lo[0] == 0 and want_hi[1] == W


def test_mj_ranges_plain_equals_searchsorted():
    """The co-sort method gives each masked lane the lower and upper bound
    of its flag-free key (``torch.searchsorted``, the kernel's library
    yardstick); lanes outside the mask get (0, 0)."""
    hi, lo, phi, plo, mask = _join_case(4, 3000, 2000, 10, 3)
    skey = torch.from_numpy(_port_key(hi, lo))
    pkey = torch.from_numpy(_port_probe_key(phi, plo))
    m = torch.from_numpy(mask)
    got_lo, got_hi, totals = mj_ranges(skey, pkey, m, [0, 2010])
    left = torch.searchsorted(skey >> 1, pkey >> 1, side="left")
    right = torch.searchsorted(skey >> 1, pkey >> 1, side="right")
    assert torch.equal(got_lo.long(), torch.where(m, left, 0))
    assert torch.equal(got_hi.long(), torch.where(m, right, 0))
    assert int(totals[0]) == int(torch.where(m, right - left, 0).sum())
    with pytest.raises(ValueError, match="lane arrays"):
        mj_ranges(skey, pkey, m[:-1], [0, 2010])
    with pytest.raises(ValueError, match="dtype"):
        mj_ranges(skey.to(torch.int32), pkey, m, [0, 2010])
