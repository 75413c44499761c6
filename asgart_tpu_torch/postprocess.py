"""Post-processing pipeline steps over proto-duplicon families.

Reproduces the reference `Step` chain (``src/bin/asgart.rs:28-112`` and
``:482-562``): FilterNs → ReOrder → ReduceOverlap → [ComputeScore] → Sort.
Reference quirks preserved deliberately (they shape the JSON output):

  * ``ReOrder`` swaps only the positions, never the lengths
    (asgart.rs:39-50),
  * ``merge`` mixes ``left_length``/``right_length`` in its extents
    (asgart.rs:497-513),
  * ``reduce_overlap`` iterates to a fixpoint on the family *size* only
    (asgart.rs:553-561).
"""

from __future__ import annotations

from .structs import ProtoSD


def _pack_csr(families: list[list[ProtoSD]]):
    import numpy as np

    offsets = np.zeros(len(families) + 1, dtype=np.int64)
    total = 0
    for f, fam in enumerate(families):
        total += len(fam)
        offsets[f + 1] = total
    sds = np.empty((total, 4), dtype=np.int64)
    i = 0
    for fam in families:
        for sd in fam:
            sds[i] = (sd.left, sd.right, sd.left_length, sd.right_length)
            i += 1
    return sds, offsets


def filter_ns(families: list[list[ProtoSD]],
              strand: bytes) -> list[list[ProtoSD]]:
    """Drop duplicons with > 20% N in either arm (asgart.rs:81-96).
    Record-parallel in the native runtime (rayon analog: asgart.rs:89)."""
    from . import native

    sds, _ = _pack_csr(families)
    if not len(sds):
        return []
    keep = native.filter_ns_flags(sds, strand)
    out = []
    i = 0
    for family in families:
        kept = [sd for sd, k in zip(family, keep[i:i + len(family)]) if k]
        i += len(family)
        if kept:
            out.append(kept)
    return out


def filter_ns_py(families: list[list[ProtoSD]],
                 strand: bytes) -> list[list[ProtoSD]]:
    """Pure-Python oracle of :func:`filter_ns`.

    The threshold compare happens in f32 like the reference
    (``n_content() <= 0.2`` with an f32 n_content infers an f32 literal,
    asgart.rs:89 / structs.rs:453): an arm at exactly 2/10 N is KEPT.
    Round 1 compared in f64 and wrongly dropped it.
    """
    import numpy as np

    thr = float(np.float32(0.2))
    out = []
    for family in families:
        kept = [sd for sd in family if sd.n_content(strand) <= thr]
        if kept:
            out.append(kept)
    return out


def re_order(families: list[list[ProtoSD]]) -> list[list[ProtoSD]]:
    """Swap left/right positions so left <= right (asgart.rs:33-51).
    Lengths are intentionally NOT swapped, as in the reference."""
    for family in families:
        for sd in family:
            if sd.left > sd.right:
                sd.left, sd.right = sd.right, sd.left
    return families


def _subsegment(x: tuple[int, int], y: tuple[int, int]) -> bool:
    xstart, xlen = x
    ystart, ylen = y
    return xstart >= ystart and xstart + xlen <= ystart + ylen


def _overlap(x: tuple[int, int], y: tuple[int, int]) -> bool:
    xstart, xlen = x
    ystart, ylen = y
    xend, yend = xstart + xlen, ystart + ylen
    return (ystart <= xstart <= yend and xend >= yend) or \
           (xstart <= ystart <= xend and yend >= xend)


def _merge(x: ProtoSD, y: ProtoSD) -> ProtoSD:
    """(asgart.rs:497-513) — note the left/right length mixing."""
    new_left = min(x.left, y.left)
    lsize = max(x.left + x.left_length, y.left + y.right_length) - new_left
    new_right = min(x.right, y.right)
    rsize = max(x.right + x.left_length, y.right + y.right_length) - new_right
    return ProtoSD(
        left=new_left, right=new_right,
        left_length=lsize, right_length=rsize,
        identity=0.0, reversed=x.reversed, complemented=x.complemented)


def _reduce_once(family: list[ProtoSD]) -> list[ProtoSD]:
    news: list[ProtoSD] = []
    for x in family:
        absorbed = False
        for y in news:
            if _subsegment(x.left_part(), y.left_part()) and \
                    _subsegment(x.right_part(), y.right_part()):
                absorbed = True
                break
            if _subsegment(y.left_part(), x.left_part()) and \
                    _subsegment(y.right_part(), x.right_part()):
                y.left, y.right = x.left, x.right
                y.left_length, y.right_length = x.left_length, x.right_length
                absorbed = True
                break
            if _overlap(x.left_part(), y.left_part()) and \
                    _overlap(x.right_part(), y.right_part()):
                z = _merge(x, y)
                y.left, y.right = z.left, z.right
                y.left_length, y.right_length = z.left_length, z.right_length
                absorbed = True
                break
        if not absorbed:
            news.append(ProtoSD(**vars(x)))
    return news


def reduce_overlap_family(family: list[ProtoSD]) -> list[ProtoSD]:
    """Fixpoint overlap reduction (asgart.rs:515-562)."""
    old_size = len(family)
    news = _reduce_once(family)
    while len(news) < old_size:
        old_size = len(news)
        news = _reduce_once(news)
    return news


def reduce_overlap(families: list[list[ProtoSD]]) -> list[list[ProtoSD]]:
    """Family-parallel fixpoint reduction in the native runtime."""
    from . import native

    if not families:
        return families
    sds, offsets = _pack_csr(families)
    out_sds, out_offsets = native.reduce_overlap_csr(sds, offsets)
    out = []
    for f, family in enumerate(families):
        if not family:
            out.append([])
            continue
        proto = family[0]
        out.append([
            ProtoSD(left=int(row[0]), right=int(row[1]),
                    left_length=int(row[2]), right_length=int(row[3]),
                    identity=0.0, reversed=proto.reversed,
                    complemented=proto.complemented)
            for row in out_sds[out_offsets[f]:out_offsets[f + 1]]])
    return out


def reduce_overlap_py(families: list[list[ProtoSD]]) -> list[list[ProtoSD]]:
    """Pure-Python oracle of :func:`reduce_overlap`."""
    return [reduce_overlap_family(f) for f in families]


def compute_score(families: list[list[ProtoSD]],
                  strand: bytes) -> list[list[ProtoSD]]:
    """Levenshtein identity (asgart.rs:98-112); f64 → f32 cast at store.
    Duplicon-parallel: the native Myers kernel releases the GIL, so a
    thread pool gets real concurrency (rayon analog: asgart.rs:105)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    flat = [sd for family in families for sd in family]
    if not flat:
        return families

    def score(sd):
        sd.identity = float(np.float32(sd.levenshtein(strand)))

    workers = min(len(flat), os.cpu_count() or 1)
    if workers > 1 and len(flat) > 8:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(score, flat))
    else:
        for sd in flat:
            score(sd)
    return families


def sort_families(families: list[list[ProtoSD]]) -> list[list[ProtoSD]]:
    """Stable sort within each family by left position (asgart.rs:53-65)."""
    for family in families:
        family.sort(key=lambda sd: sd.left)
    return families
