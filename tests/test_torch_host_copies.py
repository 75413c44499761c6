"""Each host module and function the port copies out of the JAX package
equals its original: the whole modules (asgart_tpu_torch/{structs, utils,
json_io, exporters, fasta, index, postprocess}.py, native/ and its C++
source) as text once their import lines are normalised, the pipeline's
host stages, the CLI parser and the benchmark's synthetic genome
(asgart_tpu_torch/synthetic.py) function by function, and the helpers of
asgart_tpu_torch/host_helpers.py by value. The few lines that must
differ are listed here."""

import difflib
import inspect
import os

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest

from asgart_tpu import device_engine as de
from asgart_tpu import device_index as di
from asgart_tpu_torch import host_helpers as hh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _original_line(name: str, needle: str) -> str:
    """The stripped line of asgart_tpu/``name`` that holds ``needle``."""
    with open(os.path.join(REPO, "asgart_tpu", name)) as fh:
        return next(line.strip() for line in fh if needle in line)


# copy (under asgart_tpu_torch/) -> (lines only in the original, lines
# only in the copy), stripped; every other line is equal
WHOLE_FILES = {
    "structs.py": ((), ()),
    "utils.py": ((), ()),
    "json_io.py": ((), ()),
    "exporters.py": ((), ()),
    "fasta.py": ((), ()),
    "index.py": ((), ()),
    "postprocess.py": ((), ()),
    "native/src/asgart_native.cpp": ((), ()),
    # the library is built into the checkout's build/ directory, through
    # a temporary file renamed into place (concurrent first imports); and
    # the docstring line naming the machine it was tuned on is reworded
    "native/__init__.py": (
        ('_LIB = os.path.join(_HERE, "libasgart_native.so")',
         _original_line("native/__init__.py", "fault tax"),
         'base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", '
         '_LIB, _SRC]'),
        ('_LIB = os.path.join(os.path.dirname(os.path.dirname(_HERE)), '
         '"build",',
         '"asgart_tpu_torch", "libasgart_native.so")',
         'on the host it was tuned on (~6 s/GB fault tax)."""',
         'os.makedirs(os.path.dirname(_LIB), exist_ok=True)',
         'tmp = f"{_LIB}.{os.getpid()}.tmp"',
         'base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", '
         'tmp, _SRC]',
         '# concurrent builders never expose a half-written library',
         'os.replace(tmp, _LIB)')),
}

# SearchEngine without its engine="tpu" device attachment (seed.py)
SEARCH_ENGINE_REMOVED = (
    "self._device = None",
    'if engine == "tpu" and attach_device and self.bidx is None:',
    "# (wide probes run fully on the host: no device attachment)",
    "if self.pidx is not None:",
    "from .seed import DevicePositionTables",
    "self._device = DevicePositionTables(self.pidx)",
    "elif settings.probe_size * 3 <= 60:",
    "from .seed import DeviceSeedIndex",
    "self._device = DeviceSeedIndex(self.index)",
    "else:",
    "# k=21 exceeds the two-plane device packing: host lookup",
    'log.warning("probe_size %d trim lookup runs on the host",',
    "settings.probe_size)",
    "elif self._device is not None:",
    "x = self.pidx.probe_table_positions(start, length, is_)",
    "lo, hi = self._device.gather_ranges(x)",
    "if self._device is not None:",
    "lo, hi = self._device.lookup(probe_kmers)",
    "else:",
    "lo, hi = self.index.lookup(probe_kmers)",  # dedented below
)


def _normalise(text: str) -> str:
    """The text with the port's package name in import lines read as the
    JAX package's."""
    return "\n".join(
        line.replace("asgart_tpu_torch", "asgart_tpu")
        if line.lstrip().startswith(("from ", "import ")) else line
        for line in text.splitlines())


def _diff(original: str, copy: str):
    """(lines only in the original, lines only in the copy), stripped, in
    order."""
    d = list(difflib.ndiff(_normalise(original).splitlines(),
                           _normalise(copy).splitlines()))
    return (tuple(x[2:].strip() for x in d if x.startswith("- ")),
            tuple(x[2:].strip() for x in d if x.startswith("+ ")))


@pytest.mark.parametrize("name", sorted(WHOLE_FILES))
def test_whole_module_copy_equals_original(name):
    with open(os.path.join(REPO, "asgart_tpu", name)) as fh:
        original = fh.read()
    with open(os.path.join(REPO, "asgart_tpu_torch", name)) as fh:
        copy = fh.read()
    assert _diff(original, copy) == WHOLE_FILES[name]


@pytest.mark.parametrize("name", ["probe_positions", "transform_needle",
                                  "_pack_probe_kmers",
                                  "raw_families_to_protosds",
                                  "_finalize_result", "SearchEngine"])
def test_pipeline_host_stage_copy_equals_original(name):
    from asgart_tpu import pipeline as jax_pipeline
    from asgart_tpu_torch import pipeline

    want = ((), ())
    if name == "SearchEngine":
        want = (SEARCH_ENGINE_REMOVED,
                ("lo, hi = self.index.lookup(probe_kmers)",))
    assert _diff(inspect.getsource(getattr(jax_pipeline, name)),
                 inspect.getsource(getattr(pipeline, name))) == want


def test_cli_parser_copy_equals_original():
    from asgart_tpu.cli import main as jax_cli
    from asgart_tpu_torch.cli import main as cli

    assert _diff(inspect.getsource(jax_cli.build_parser),
                 inspect.getsource(cli.build_parser)) == (
        ('"(TPU-native)")',
         'p.add_argument("--engine", choices=["host", "tpu"], '
         'default="host",',
         'help="Seed-lookup engine (host numpy or TPU)")'),
        ('"(PyTorch / CUDA port)")',
         'p.add_argument("--engine", choices=["host", "cuda"], '
         'default="host",',
         'help="Seed-lookup engine (host numpy or CUDA GPU)")'))
    # every flag of the original, in the same order
    dests = [[a.dest for a in m.build_parser()._actions]
             for m in (jax_cli, cli)]
    assert dests[0] == dests[1]


def test_synthetic_genome_copy_equals_original():
    import bench
    from asgart_tpu_torch import synthetic

    assert _diff(inspect.getsource(bench.synthetic_genome),
                 inspect.getsource(synthetic.synthetic_genome)) == ((), ())
    for n in (50_000, 2_100_000):
        assert np.array_equal(
            synthetic.synthetic_genome(n, np.random.default_rng(1234)),
            bench.synthetic_genome(n, np.random.default_rng(1234)))


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
