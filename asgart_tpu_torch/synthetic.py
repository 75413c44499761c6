"""The synthetic genome of the repo's benchmark, for the port's own runs.

``synthetic_genome`` is a copy of ``bench.synthetic_genome`` (the JAX
package's benchmark script), so that ``chip_smoke.py`` builds the same
genome from the same seed without importing that script;
tests/test_torch_host_copies.py pins the copy against its original.
"""

from __future__ import annotations

import numpy as np


def synthetic_genome(n: int, rng: np.random.Generator) -> np.ndarray:
    """chr1-like content: random background, planted SD families (direct
    and reverse-complemented), Alu-like repeat scatter, N runs."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.choice(acgt, n)

    # Alu-like scatter: one 300bp element, ~0.5% of the genome, 10% noise
    alu = rng.choice(acgt, 300)
    n_alu = max(1, int(n * 0.005 / 300))
    for _ in range(n_alu):
        p = int(rng.integers(0, n - 300))
        elt = alu.copy()
        mask = rng.random(300) < 0.10
        elt[mask] = rng.choice(acgt, int(mask.sum()))
        g[p: p + 300] = elt

    # planted SD families
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    n_sds = max(2, int(n / 2_000_000))
    for s in range(n_sds):
        dup_len = int(rng.integers(2_000, 30_000))
        src = int(rng.integers(0, n - dup_len))
        dst = int(rng.integers(0, n - dup_len))
        seg = g[src: src + dup_len].copy()
        mask = rng.random(dup_len) < 0.02
        seg[mask] = rng.choice(acgt, int(mask.sum()))
        if s % 2 == 1:  # reverse-complemented copy
            seg = comp[seg][::-1]
        g[dst: dst + dup_len] = seg

    # centromere-like N run
    mid = n // 2
    g[mid: mid + 30_000] = ord("N")
    return g
