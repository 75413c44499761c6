"""Small helpers mirroring the reference's ``src/utils.rs``."""

from __future__ import annotations

import pathlib

import numpy as np

# complement_nucleotide (utils.rs:1-17): unknown bytes map to 'N'
_COMPLEMENT_LENIENT = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ATGCNatgcn", b"TACGNtacgn"):
    _COMPLEMENT_LENIENT[_a] = _b


def complement_nucleotide(n: int) -> int:
    return int(_COMPLEMENT_LENIENT[n])


def complemented(text: np.ndarray) -> np.ndarray:
    """Vectorized lenient complement (utils.rs:19-23)."""
    return _COMPLEMENT_LENIENT[text]


class ProgressBar:
    """Lightweight stderr progress bar (the reference drives an indicatif
    bar from a monitor thread polling per-chunk atomics, asgart.rs:160-197;
    we render inline from the chunk loop)."""

    def __init__(self, total: int, enabled: bool = True,
                 min_interval: float = 0.5):
        import sys
        import time

        self.total = max(total, 1)
        self.enabled = enabled and sys.stderr.isatty()
        self.min_interval = min_interval
        self._last = 0.0
        self._time = time
        self._start = time.time()

    def update(self, done: int, force: bool = False):
        if not self.enabled:
            return
        import sys

        now = self._time.time()
        if not force and now - self._last < self.min_interval:
            return
        self._last = now
        frac = min(done / self.total, 1.0)
        width = 40
        filled = int(frac * width)
        elapsed = now - self._start
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        sys.stderr.write(
            f"\r[{'#' * filled}{'-' * (width - filled)}] "
            f"{frac * 100:5.1f}%  (~{eta:4.0f}s remaining)")
        sys.stderr.flush()

    def finish(self):
        if not self.enabled:
            return
        import sys

        self.update(self.total, force=True)
        sys.stderr.write("\n")
        sys.stderr.flush()


def slugify(x: str) -> str:
    """(utils.rs:25-28)"""
    out = x.strip()
    for ch in (" ", ":", "|"):
        out = out.replace(ch, "_")
    return out


def make_out_filename(filename, default: str, extension: str) -> pathlib.Path:
    """(utils.rs:30-49): directory targets get the default stem appended;
    the extension is (re)set like Rust's ``PathBuf::set_extension``."""
    if filename is not None:
        path = pathlib.Path(filename)
        if path.is_dir():
            path = path / default
    else:
        path = pathlib.Path(default)
    # PathBuf::set_extension: replace the part after the last '.' of the
    # final component (a leading dot does not count as an extension sep).
    name = path.name
    stem = path.stem if path.stem else name
    return path.with_name(f"{stem}.{extension}" if extension else stem)


def pow2_ceil(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n (and >= lo)."""
    b = lo
    while b < n:
        b <<= 1
    return b
