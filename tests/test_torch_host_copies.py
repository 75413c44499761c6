"""Each host helper that the port copies out of a JAX-importing module
(asgart_tpu_torch/host_helpers.py) equals its original."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest

from asgart_tpu import device_engine as de
from asgart_tpu import device_index as di
from asgart_tpu_torch import host_helpers as hh


def test_comp_code_and_b_gran():
    assert np.array_equal(hh.COMP_CODE, di.COMP_CODE)
    assert hh.COMP_CODE.dtype == di.COMP_CODE.dtype
    assert hh.B_GRAN == de.B_GRAN


def test_bucket():
    ns = list(range(0, 5000, 7)) + [(1 << 16) - 1, 1 << 16, (1 << 16) + 1,
                                    (1 << 20) - 1, 1 << 20, (1 << 20) + 1,
                                    3 << 20, 12_800_001, 64_000_000]
    for n in ns:
        assert hh._bucket(n) == de._bucket(n), n
        assert hh._bucket(n, lo=1 << 10) == de._bucket(n, lo=1 << 10), n


@pytest.mark.parametrize("k", [8, 20])
def test_probe_x0(k):
    rng = np.random.default_rng(5)
    for _ in range(200):
        n1 = int(rng.integers(100, 10**9))
        cs = int(rng.integers(0, n1 - 50))
        cl = int(rng.integers(1, n1 - cs))
        for rev in (False, True):
            for comp in (False, True):
                assert hh._probe_x0(cs, cl, n1, k, rev, comp) == \
                    de._probe_x0(cs, cl, n1, k, rev, comp)


def test_strand_fingerprint():
    rng = np.random.default_rng(6)
    # one slice, and more than one 32 MiB slice (the threaded path)
    for n in (0, 1, 12345, (32 << 20) + 17):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert hh._strand_fingerprint(data) == di._strand_fingerprint(data)


def test_merge_shard_events():
    rng = np.random.default_rng(7)
    for _ in range(50):
        parts = []
        for _ in range(int(rng.integers(1, 6))):
            ne = int(rng.integers(0, 4))
            ev = rng.integers(0, 100, (3, ne)).astype(np.int32)
            m = rng.integers(0, 1000, int(ev[2].sum())).astype(np.int32)
            parts.append((ev, m, int(rng.integers(0, 9))))
        got = hh._merge_shard_events(parts)
        want = de._merge_shard_events(parts)
        assert got[2] == want[2]
        if want[0] is None:
            assert got[0] is None and got[1] is None
        else:
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
