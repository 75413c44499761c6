"""The port imports torch and never jax nor the JAX package
(``asgart_tpu``, not even its modules that import no jax), and names its
device explicitly: without CUDA, the cuda engine raises, and a kernel
wrapper handed a GPU tensor goes to its kernel (and raises here) instead
of quietly running its plain version."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from torch_jax_ref import one_port_test_at_a_time  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(
    os.path.relpath(f, REPO) for f in
    glob.glob(os.path.join(REPO, "asgart_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py", "scripts/kd_kc_probe.py",
                                  "scripts/kj_kh_probe.py",
                                  "scripts/ka_kl_probe.py",
                                  "scripts/kk_dir_probe.py",
                                  "scripts/kt_ki_probe.py",
                                  "scripts/km_kf_probe.py",
                                  "scripts/kn_probe.py"]
# bench.py is the JAX package's benchmark script
FORBIDDEN = ("jax", "jaxlib", "asgart_tpu", "bench")

# every port module, then the three ways a user runs it on the CPU; none
# may bring jax or any asgart_tpu module into the process
RUN_ALL = '''
import pkgutil, sys, numpy as np, torch
import asgart_tpu_torch
for m in pkgutil.walk_packages(asgart_tpu_torch.__path__,
                               "asgart_tpu_torch."):
    __import__(m.name)
from asgart_tpu_torch.cli.main import main
from asgart_tpu_torch.pipeline import search_duplications
from asgart_tpu_torch.structs import RunSettings
rng = np.random.default_rng(3)
g = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 30000)
g[20000:23000] = g[4000:7000]
fa = sys.argv[1] + "/g.fa"
with open(fa, "wb") as fh:
    fh.write(b">chr1\\n" + g.tobytes() + b"\\n")
s = RunSettings()
host = search_duplications([fa], s, engine="host")
port = search_duplications([fa], s, engine="cuda",
                           device=torch.device("cpu"))
assert host.families and len(host.families) == len(port.families)
assert main([fa, "--engine", "host", "--out", sys.argv[1] + "/o.json"]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
             or m == "asgart_tpu" or m.startswith("asgart_tpu."))
assert not bad, bad
print("ok")
'''


def _imports(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax_package(path):
    """No module of the port, and not chip_smoke.py, imports jax or any
    module of the JAX package (an AST scan of every import statement,
    module level or inside a function)."""
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import asgart_tpu_torch, asgart_tpu_torch.pipeline\n"
        "import asgart_tpu_torch.cli.main, asgart_tpu_torch.convert\n"
        "import asgart_tpu_torch.device_engine, asgart_tpu_torch.kernels\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m == 'asgart_tpu'\n"
        "            or m.startswith('asgart_tpu.')], 'asgart_tpu imported'\n"
        "print('ok')\n")
    # `python -c` puts the working directory (the repo root) on sys.path
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_runs_without_jax_package(tmp_path):
    """Every port module imported, a host-engine search, a cuda-engine
    search on the CPU and the CLI, all in one fresh process: afterwards
    neither jax nor any asgart_tpu module is loaded."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", RUN_ALL, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip() == "ok"


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA behaviour is moot")


def test_cuda_engine_raises_without_cuda(tmp_path):
    _require_no_cuda()
    from asgart_tpu_torch.structs import RunSettings
    from asgart_tpu_torch.device import cuda_device
    from asgart_tpu_torch.pipeline import search_duplications

    from util import random_dna, write_fasta
    import numpy as np

    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", random_dna(np.random.default_rng(1), 5000))])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        search_duplications([str(fa)], RunSettings(), engine="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        search_duplications([str(fa)], RunSettings(), engine="cuda",
                            device=torch.device("cuda"))


def test_wrappers_take_kernel_path_for_gpu_tensors(monkeypatch):
    """With the inputs reported as GPU tensors, every wrapper asks for the
    kernel library (which raises here) and never runs its plain
    version."""
    import importlib

    from asgart_tpu_torch.kernels import (_build, chain_bursts, equal_range,
                                          gather_flat, gather_owned,
                                          gather_ranges, granule_totals,
                                          group_bounds,
                                          invert_fused, mj_ranges,
                                          pack_keys, pack_probe_planes,
                                          scan_core,
                                          tie_keys, tie_refine, unpack_codes)

    def mod(name):  # the module, not the wrapper of the same name
        return importlib.import_module(f"asgart_tpu_torch.kernels.{name}")

    def no_lib():
        raise RuntimeError("kernel library requested")

    def no_plain(*a, **k):
        raise AssertionError("plain version used for a GPU tensor")

    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", no_lib)
    for m, name in (("pack_keys", "pack_keys_plain"),
                    ("group_bounds", "group_bounds_plain"),
                    ("invert", "invert_fused_plain"),
                    ("scan_core", "scan_core_plain"),
                    ("ties", "tie_keys_plain"),
                    ("ties", "tie_refine_plain"),
                    ("merge_join", "mj_ranges_plain"),
                    ("codes", "unpack_codes_plain"),
                    ("chain", "chain_bursts_plain"),
                    ("slices", "granule_totals_plain"),
                    ("slices", "gather_flat_plain"),
                    ("seed", "equal_range_plain"),
                    ("seed", "_buckets_inside"),  # KQ checks on the card
                    ("seed", "gather_ranges_plain"),
                    ("seed", "pack_probe_planes_plain"),
                    ("sharded", "gather_owned_plain")):
        monkeypatch.setattr(mod(m), name, no_plain)

    i32, i64 = torch.int32, torch.int64
    codes = torch.ones(100, dtype=torch.uint8)
    for k in (20, 25):
        with pytest.raises(RuntimeError, match="kernel library"):
            pack_keys(codes, ((0, 99, 7),), k, True, True, 100, 16)
        with pytest.raises(RuntimeError, match="kernel library"):
            pack_keys(codes, ((0, 99, 7),), k, True, True, 41, 16, ws=30)
    with pytest.raises(RuntimeError, match="kernel library"):
        pack_keys(codes, ((0, 99, 7),), 20, True, True, 0, 16)  # probe-only
    with pytest.raises(RuntimeError, match="kernel library"):
        pack_keys(codes, (), 20, False, False, 41, 0, ws=30)  # window keys
    with pytest.raises(RuntimeError, match="kernel library"):
        mj_ranges(torch.arange(8, dtype=i64), torch.arange(4, dtype=i64),
                  torch.ones(4, dtype=torch.bool), [0, 4])
    with pytest.raises(RuntimeError, match="kernel library"):
        group_bounds([torch.arange(8, dtype=i64)],
                     torch.arange(8, dtype=i32), 4)
    with pytest.raises(RuntimeError, match="kernel library"):
        group_bounds([torch.arange(8, dtype=i64), torch.zeros(8, dtype=i32)],
                     torch.arange(8, dtype=i32), 4)
    with pytest.raises(RuntimeError, match="kernel library"):
        tie_keys(torch.arange(4, dtype=i32), torch.zeros(4, dtype=i32),
                 torch.zeros(8, dtype=i32), 2, torch.zeros(1, dtype=i32))
    with pytest.raises(RuntimeError, match="kernel library"):
        tie_refine(torch.arange(4, dtype=i64), torch.arange(4, dtype=i64),
                   torch.arange(4, dtype=i32), torch.arange(4, dtype=i32),
                   torch.zeros(8, dtype=i32), torch.zeros(8, dtype=i32),
                   torch.zeros(1, dtype=i32))
    with pytest.raises(RuntimeError, match="kernel library"):
        invert_fused(torch.arange(8, dtype=i32), torch.zeros(8, dtype=i32),
                     torch.zeros(8, dtype=i32),
                     torch.zeros(4, dtype=torch.bool), 4, [0, 4])
    with pytest.raises(RuntimeError, match="kernel library"):
        scan_core(torch.zeros(4, dtype=i32), torch.zeros(4, dtype=i32),
                  torch.ones(4, dtype=torch.bool),
                  torch.arange(8, dtype=i32), 0, 0, 100, 500, 0, 20, False)
    with pytest.raises(RuntimeError, match="kernel library"):
        unpack_codes(torch.zeros(3, dtype=torch.uint8),
                     torch.zeros(1, dtype=i64),
                     torch.zeros(1, dtype=torch.uint8), 10)
    with pytest.raises(RuntimeError, match="kernel library"):
        chain_bursts(torch.zeros(2, dtype=i32), torch.zeros(2, dtype=i32),
                     torch.arange(3, dtype=i64), torch.ones(2, dtype=i32), 0,
                     torch.tensor([0, 2]), torch.zeros(1, dtype=i32),
                     torch.zeros(1, dtype=i32), 12, 20, 10, 120, 1000, 256,
                     64)
    with pytest.raises(RuntimeError, match="kernel library"):
        granule_totals(torch.zeros(5, dtype=i32), torch.ones(5, dtype=i32),
                       torch.ones(5, dtype=torch.bool), 2)
    with pytest.raises(RuntimeError, match="kernel library"):
        gather_flat([torch.arange(4, dtype=i32), torch.arange(3, dtype=i32)],
                    torch.tensor([6, 0, 3]))
    with pytest.raises(RuntimeError, match="kernel library"):
        equal_range(torch.arange(8, dtype=i64),
                    torch.tensor([0, 4, 8], dtype=i32),
                    torch.tensor([3, 1 << 30]), 4, 0)
    with pytest.raises(RuntimeError, match="kernel library"):
        equal_range(torch.arange(8, dtype=i64), torch.zeros(0, dtype=i32),
                    torch.tensor([3]), 4, -1)
    with pytest.raises(RuntimeError, match="kernel library"):
        mod("seed").equal_range_reads(torch.arange(8, dtype=i64),
                                      torch.zeros(0, dtype=i32),
                                      torch.tensor([3]), 4, -1)
    with pytest.raises(RuntimeError, match="kernel library"):
        gather_ranges(torch.arange(6, dtype=i32), torch.arange(6, dtype=i32),
                      torch.tensor([5, 0]))
    with pytest.raises(RuntimeError, match="kernel library"):
        pack_probe_planes(torch.ones(30, dtype=torch.uint8),
                          torch.tensor([0, 10]), 20)
    with pytest.raises(RuntimeError, match="kernel library"):
        gather_owned(torch.tensor([0, 2], dtype=i32),
                     torch.tensor([2, 5], dtype=i32),
                     torch.ones(2, dtype=torch.bool),
                     torch.tensor([0, 2]), 5, torch.arange(3, dtype=i32), 1)
