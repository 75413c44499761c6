"""The port imports torch and never jax, and names its device explicitly:
without CUDA, the cuda engine raises, and a kernel wrapper handed a GPU
tensor goes to its kernel (and raises here) instead of quietly running its
plain version."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import asgart_tpu_torch, asgart_tpu_torch.pipeline\n"
        "import asgart_tpu_torch.cli.main, asgart_tpu_torch.convert\n"
        "import asgart_tpu_torch.device_engine, asgart_tpu_torch.kernels\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'asgart_tpu.device_index' not in sys.modules\n"
        "assert 'asgart_tpu.device_engine' not in sys.modules\n"
        "print('ok')\n")
    # `python -c` puts the working directory (the repo root) on sys.path
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA behaviour is moot")


def test_cuda_engine_raises_without_cuda(tmp_path):
    _require_no_cuda()
    from asgart_tpu.structs import RunSettings
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

    from asgart_tpu_torch.kernels import (_build, group_bounds,
                                          invert_fused, pack_keys,
                                          scan_core)

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
                    ("scan_core", "scan_core_plain")):
        monkeypatch.setattr(mod(m), name, no_plain)

    i32, i64 = torch.int32, torch.int64
    codes = torch.ones(100, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="kernel library"):
        pack_keys(codes, ((0, 99, 7),), 20, True, True, 100, 16)
    with pytest.raises(RuntimeError, match="kernel library"):
        group_bounds(torch.arange(8, dtype=i64), torch.arange(8, dtype=i32),
                     4)
    with pytest.raises(RuntimeError, match="kernel library"):
        invert_fused(torch.arange(8, dtype=i32), torch.zeros(8, dtype=i32),
                     torch.zeros(8, dtype=i32),
                     torch.zeros(4, dtype=torch.bool), 4, [0, 4])
    with pytest.raises(RuntimeError, match="kernel library"):
        scan_core(torch.zeros(4, dtype=i32), torch.zeros(4, dtype=i32),
                  torch.ones(4, dtype=torch.bool),
                  torch.arange(8, dtype=i32), 0, 100, 500, 0, 20, False)
