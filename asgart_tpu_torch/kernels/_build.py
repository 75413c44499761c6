"""Build and load the hand-written CUDA kernels.

``asgart_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface under
``<checkout>/build/asgart_tpu_torch/``, at first use, and again whenever a
hash of the sources and flags changes (the hash is in the file name).
The library is loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, and every entry point returns ``cudaGetLastError()`` after
its launches, which :func:`check` turns into an exception.

Nothing is downloaded and nothing outside the checkout is compiled in;
PyTorch's headers are not included, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "asgart_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
NVCC_LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# entry point -> argument types (all return int: a cudaError_t)
SIGNATURES = {
    # codes, n1, lane_off [n_chunks + 1], x0cl [n_chunks, 2], n_chunks, W,
    # ws, total, k, reverse, complement, key, key_lo (None: one word),
    # lane_mask, stream
    "asgart_pack_keys": [_P, _I64, _P, _P, _I32, _I64, _I64, _I64, _I32,
                         _I32, _I32, _P, _P, _P, _P],
    # skey, skey_lo (None: one word), sa, M, W, run_lo, run_hi, tied,
    # stream
    "asgart_group_bounds": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    # ps, prims, rank, n, W, h, key, bad, stream
    "asgart_tie_keys": [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P],
    # skey, order, slots, ps, n, sa, rank, p_sorted, rs, still, stream
    "asgart_tie_refine": [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P],
    # sa, run_lo, run_hi, lane_mask, M, W, lane_off [n_chunks + 1],
    # n_chunks, rank, lane_lo, lane_hi, totals, stream
    "asgart_invert_fused": [_P, _P, _P, _P, _I64, _I64, _P, _I32, _P, _P,
                            _P, _P, _P],
    # lane_lo, lane_hi, lane_mask, sa, n_lanes, chunk_start, chunk_len,
    # max_cardinality, j0, k, reverse, max_match_pos, flags, stream
    "asgart_scan_count": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I64,
                          _I32, _I32, _I64, _P, _P],
    # ... the same inputs, flags, cums [3, n_lanes], n_events, ev_pack,
    # m_flat, z_trail, a_evt, stream
    "asgart_scan_emit": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I64,
                         _I32, _I32, _I64, _P, _P, _I64, _P, _P, _P, _P,
                         _P],
    # sa (in place), n, ws, stream
    "asgart_offset_slots": [_P, _I64, _I32, _P],
    # skey, W, pkey, lane_mask, total, lane_off [n_chunks + 1], n_chunks,
    # lane_lo, lane_hi, totals, stream
    "asgart_mj_ranges": [_P, _I64, _P, _P, _I64, _P, _I32, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's nvcc run, if any


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                       "to build the asgart_tpu_torch kernels")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libasgart_tpu_torch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns the library's path."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objdir = tmp + ".o"
    os.makedirs(objdir, exist_ok=True)
    nvcc = _nvcc()
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(objdir, os.path.basename(s) + ".o") for s in srcs]
    t0 = time.time()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        errors = []
        for s, p in zip(srcs, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{os.path.basename(s)}:\n{err[-4000:]}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        res = subprocess.run([nvcc, *NVCC_LINK_FLAGS, "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr[-8000:])
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    os.replace(tmp, path)
    build_seconds = time.time() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.asgart_error_string.argtypes = [ctypes.c_int]
            so.asgart_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().asgart_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on one CUDA device (launch the
    kernel), False when all lie on the CPU (run the plain version);
    raises for anything else. This is the only place a wrapper chooses
    between its kernel and its plain version."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        dev = next(iter(devices))
        if dev.type == "cuda":
            return True
        if dev.type == "cpu":
            return False
    raise ValueError(f"kernel inputs on mixed or unsupported devices: "
                     f"{sorted(str(d) for d in devices)}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
