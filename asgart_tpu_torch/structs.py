"""Result data model and filter algebra.

Mirrors the reference data model (``src/structs.rs``) precisely enough that
the serialized JSON is byte-identical and the slice/plot filter algebra
behaves the same, including its quirks:

  * ``RunSettings``: ``reverse`` / ``complement`` / ``threads_count`` /
    ``compute_score`` are never serialized (structs.rs:44-57).
  * ``ReOrder`` (in the pipeline) swaps only positions, not lengths.
  * ``flatten`` keeps fragments whose name is at most 2 characters
    (structs.rs:368) and places the collapsed pseudo-chromosome at
    ``to_keep_len + 1`` (structs.rs:397).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Optional

COLLAPSED_NAME = "ASGART_COLLAPSED"

# Complement table over the 10 accepted nucleotide bytes (structs.rs:13-26).
_TR = {
    ord("A"): ord("T"), ord("T"): ord("A"), ord("G"): ord("C"),
    ord("C"): ord("G"), ord("N"): ord("N"),
    ord("a"): ord("t"), ord("t"): ord("a"), ord("g"): ord("c"),
    ord("c"): ord("g"), ord("n"): ord("n"),
}

_COMPLEMENT_TABLE = bytes(
    _TR.get(i, 0) for i in range(256)
)


def complement(seq: bytes) -> bytes:
    """Strict complement; raises on unknown nucleotides (structs.rs:28-34)."""
    out = seq.translate(_COMPLEMENT_TABLE)
    if 0 in out:
        bad = seq[out.index(0)]
        raise ValueError(f"Unknown nucleotide: `{bad}`")
    return out


@dataclass
class RunSettings:
    """Search parameters; serialized into the result JSON (structs.rs:37-58)."""

    probe_size: int = 20
    max_gap_size: int = 120  # CLI stores gap_size + probe_size (asgart.rs:681)
    min_duplication_length: int = 1000
    max_cardinality: int = 500
    trim: Optional[tuple[int, int]] = None

    reverse: bool = False          # serde(skip_serializing)
    complement: bool = False       # serde(skip_serializing)
    skip_masked: bool = False
    threads_count: int = 0         # serde(skip_serializing)
    compute_score: bool = False    # serde(skip_serializing)

    def to_json_obj(self):
        return {
            "probe_size": self.probe_size,
            "max_gap_size": self.max_gap_size,
            "min_duplication_length": self.min_duplication_length,
            "max_cardinality": self.max_cardinality,
            "trim": list(self.trim) if self.trim is not None else None,
            "skip_masked": self.skip_masked,
        }

    @classmethod
    def from_json_obj(cls, obj) -> "RunSettings":
        trim = obj.get("trim")
        return cls(
            probe_size=obj["probe_size"],
            max_gap_size=obj["max_gap_size"],
            min_duplication_length=obj["min_duplication_length"],
            max_cardinality=obj["max_cardinality"],
            trim=tuple(trim) if trim is not None else None,
            reverse=obj.get("reverse", False),
            complement=obj.get("complement", False),
            skip_masked=obj["skip_masked"],
            threads_count=obj.get("threads_count", 0),
            compute_score=obj.get("compute_score", False),
        )


@dataclass
class Start:
    """One fragment (chromosome/contig) in the concatenated strand
    (structs.rs:60-65)."""

    name: str
    position: int
    length: int

    def to_json_obj(self):
        return {"name": self.name, "position": self.position,
                "length": self.length}

    @classmethod
    def from_json_obj(cls, obj) -> "Start":
        return cls(name=obj["name"], position=obj["position"],
                   length=obj["length"])


@dataclass
class StrandResult:
    """The searched dataset: name, total length, fragment map
    (structs.rs:67-91)."""

    name: str
    length: int
    map: list[Start] = field(default_factory=list)

    def has_chr(self, name: str) -> bool:
        return any(chr_.name == name for chr_ in self.map)

    def find_chr(self, name: str) -> Optional[Start]:
        for chr_ in self.map:
            if chr_.name == name:
                return chr_
        return None

    def find_chr_index(self, name: str) -> Optional[int]:
        for i, chr_ in enumerate(self.map):
            if chr_.name == name:
                return i
        return None

    def find_chr_by_pos(self, pos: int) -> Optional[Start]:
        for chr_ in self.map:
            if chr_.position <= pos < chr_.position + chr_.length:
                return chr_
        return None

    def to_json_obj(self):
        return {
            "name": self.name,
            "length": self.length,
            "map": [s.to_json_obj() for s in self.map],
        }

    @classmethod
    def from_json_obj(cls, obj) -> "StrandResult":
        return cls(
            name=obj["name"],
            length=obj["length"],
            map=[Start.from_json_obj(s) for s in obj["map"]],
        )


@dataclass
class ProtoSD:
    """A proto-duplicon in global strand coordinates (structs.rs:418-429)."""

    left: int
    right: int
    left_length: int
    right_length: int
    identity: float = 0.0
    reversed: bool = False
    complemented: bool = False

    def left_part(self) -> tuple[int, int]:
        return (self.left, self.left_length)

    def right_part(self) -> tuple[int, int]:
        return (self.right, self.right_length)

    def n_content(self, strand: bytes) -> float:
        """Max per-arm N fraction; arms are INCLUSIVE slices
        (structs.rs:454-467: ``strand[left..=left+left_length]``)."""
        left_arm = strand[self.left: self.left + self.left_length + 1]
        right_arm = strand[self.right: self.right + self.right_length + 1]
        ln = (left_arm.count(b"N"[0]) + left_arm.count(b"n"[0]))
        rn = (right_arm.count(b"N"[0]) + right_arm.count(b"n"[0]))
        import numpy as np
        lf = np.float32(ln) / np.float32(self.left_length)
        rf = np.float32(rn) / np.float32(self.right_length)
        return float(max(lf, rf))

    def levenshtein(self, strand: bytes) -> float:
        """Identity %; arms are INCLUSIVE slices (structs.rs:439-452)."""
        from .native import levenshtein as native_lev

        left_arm = strand[self.left: self.left + self.left_length + 1]
        right_arm = strand[self.right: self.right + self.right_length + 1]
        if self.reversed:
            right_arm = right_arm[::-1]
        if self.complemented:
            right_arm = complement(right_arm)
        dist = float(native_lev(left_arm, right_arm))
        return 100.0 * (1.0 - dist / max(self.left_length, self.right_length))


@dataclass
class SD:
    """A final duplicon with per-fragment coordinates (structs.rs:471-503)."""

    chr_left: str
    chr_right: str
    global_left_position: int
    global_right_position: int
    chr_left_position: int
    chr_right_position: int
    left_length: int
    right_length: int
    left_seq: Optional[str] = None
    right_seq: Optional[str] = None
    identity: float = 0.0
    reversed: bool = False
    complemented: bool = False

    def left_part(self) -> tuple[int, int]:
        return (self.global_left_position, self.left_length)

    def right_part(self) -> tuple[int, int]:
        return (self.global_right_position, self.right_length)

    def to_json_obj(self):
        from .json_io import F32
        return {
            "chr_left": self.chr_left,
            "chr_right": self.chr_right,
            "global_left_position": self.global_left_position,
            "global_right_position": self.global_right_position,
            "chr_left_position": self.chr_left_position,
            "chr_right_position": self.chr_right_position,
            "left_length": self.left_length,
            "right_length": self.right_length,
            "left_seq": self.left_seq,
            "right_seq": self.right_seq,
            "identity": F32(self.identity),
            "reversed": self.reversed,
            "complemented": self.complemented,
        }

    @classmethod
    def from_json_obj(cls, obj) -> "SD":
        return cls(
            chr_left=obj["chr_left"],
            chr_right=obj["chr_right"],
            global_left_position=obj["global_left_position"],
            global_right_position=obj["global_right_position"],
            chr_left_position=obj["chr_left_position"],
            chr_right_position=obj["chr_right_position"],
            left_length=obj["left_length"],
            right_length=obj["right_length"],
            left_seq=obj.get("left_seq"),
            right_seq=obj.get("right_seq"),
            identity=obj["identity"],
            reversed=obj["reversed"],
            complemented=obj["complemented"],
        )


@dataclass
class RunResult:
    """The on-disk result: the only inter-tool interface (structs.rs:93-98)."""

    strand: StrandResult
    settings: RunSettings
    families: list[list[SD]] = field(default_factory=list)

    # ---------- I/O ----------

    def to_json_obj(self):
        return {
            "strand": self.strand.to_json_obj(),
            "settings": self.settings.to_json_obj(),
            "families": [[sd.to_json_obj() for sd in fam]
                         for fam in self.families],
        }

    @classmethod
    def from_json_obj(cls, obj) -> "RunResult":
        return cls(
            strand=StrandResult.from_json_obj(obj["strand"]),
            settings=RunSettings.from_json_obj(obj["settings"]),
            families=[[SD.from_json_obj(sd) for sd in fam]
                      for fam in obj["families"]],
        )

    @classmethod
    def from_file(cls, filename: str) -> "RunResult":
        import json

        with open(filename, "r") as f:
            return cls.from_json_obj(json.load(f))

    @classmethod
    def from_stdin(cls) -> "RunResult":
        import json
        import sys

        return cls.from_json_obj(json.load(sys.stdin))

    @classmethod
    def from_files(cls, filenames: list[str]) -> "RunResult":
        """Concatenate families of several runs over the same dataset
        (structs.rs:114-141) — the merge step of the trim workflow."""
        results = [cls.from_file(f) for f in filenames]
        for result in results:
            if result.strand.name != results[0].strand.name:
                raise ValueError(
                    "Trying to combine ASGART files from different sources: "
                    f"`{result.strand.name}` and `{results[0].strand.name}`"
                )
        return cls(
            settings=results[0].settings,
            strand=results[0].strand,
            families=[fam for r in results for fam in r.families],
        )

    # ---------- filter algebra (structs.rs:143-415) ----------

    def _retain_sds(self, pred):
        for fam in self.families:
            fam[:] = [sd for sd in fam if pred(sd)]
        self.families = [f for f in self.families if f]

    def remove_direct(self):
        self._retain_sds(lambda sd: sd.reversed)

    def remove_reversed(self):
        self._retain_sds(lambda sd: not sd.reversed)

    def remove_uncomplemented(self):
        self._retain_sds(lambda sd: sd.complemented)

    def remove_complemented(self):
        self._retain_sds(lambda sd: not sd.complemented)

    def remove_inter(self):
        self._retain_sds(lambda sd: sd.chr_left == sd.chr_right)

    def remove_inter_relaxed(self):
        self._retain_sds(
            lambda sd: sd.chr_left == sd.chr_right
            or sd.chr_left == COLLAPSED_NAME
            or sd.chr_right == COLLAPSED_NAME
        )

    def remove_intra(self):
        self._retain_sds(lambda sd: sd.chr_left != sd.chr_right)

    def max_family_members(self, m: int):
        self.families = [f for f in self.families if len(f) <= m]

    def _consolidate_families(self, to_keep: list[str]):
        """Drop empty families/unused fragments, rebase global coordinates
        (structs.rs:204-228)."""
        self.families = [f for f in self.families if f]
        keep_set = set(to_keep)
        self.strand.map = [c for c in self.strand.map if c.name in keep_set]
        self.strand.length = sum(c.length for c in self.strand.map)
        i = 0
        for c in self.strand.map:
            c.position = i
            i += c.length
        for fam in self.families:
            for sd in fam:
                cl = self.strand.find_chr(sd.chr_left)
                cr = self.strand.find_chr(sd.chr_right)
                sd.global_left_position = (
                    cl.position + sd.chr_left_position if cl else 0)
                sd.global_right_position = (
                    cr.position + sd.chr_right_position if cr else 0)

    def keep_fragments(self, to_keep: list[str]):
        """Keep duplicons with AT LEAST one leg on a kept fragment
        (structs.rs:230-240)."""
        keep_set = set(to_keep)
        self._retain_sds(
            lambda sd: sd.chr_left in keep_set or sd.chr_right in keep_set)
        self._consolidate_families(to_keep)

    def keep_fragments_regexp(self, to_keep: str):
        rx = re.compile(to_keep)
        self._retain_sds(
            lambda sd: rx.search(sd.chr_left) is not None
            or rx.search(sd.chr_right) is not None)
        self._consolidate_families(
            [c.name for c in self.strand.map if rx.search(c.name)])

    def restrict_fragments(self, to_keep: list[str]):
        """Keep duplicons with BOTH legs on kept fragments
        (structs.rs:260-270)."""
        keep_set = set(to_keep)
        self._retain_sds(
            lambda sd: sd.chr_left in keep_set and sd.chr_right in keep_set)
        self._consolidate_families(to_keep)

    def restrict_fragments_regexp(self, to_keep: str):
        rx = re.compile(to_keep)
        self._retain_sds(
            lambda sd: rx.search(sd.chr_left) is not None
            and rx.search(sd.chr_right) is not None)
        self._consolidate_families(
            [c.name for c in self.strand.map if rx.search(c.name)])

    def _rebase_strict(self):
        self.strand.length = sum(c.length for c in self.strand.map)
        i = 0
        for c in self.strand.map:
            c.position = i
            i += c.length
        for fam in self.families:
            for sd in fam:
                # find_chr().unwrap() in the reference: missing chr = error
                cl = self.strand.find_chr(sd.chr_left)
                cr = self.strand.find_chr(sd.chr_right)
                if cl is None or cr is None:
                    raise KeyError(
                        f"fragment not found: {sd.chr_left if cl is None else sd.chr_right}")
                sd.global_left_position = cl.position + sd.chr_left_position
                sd.global_right_position = cr.position + sd.chr_right_position

    def exclude_fragments(self, to_exclude: list[str]):
        """(structs.rs:293-319)"""
        excl = set(to_exclude)
        self._retain_sds(
            lambda sd: sd.chr_left not in excl and sd.chr_right not in excl)
        self.strand.map = [c for c in self.strand.map if c.name not in excl]
        self._rebase_strict()

    def exclude_fragments_regexp(self, to_exclude: str):
        rx = re.compile(to_exclude)
        self._retain_sds(
            lambda sd: rx.search(sd.chr_left) is None
            and rx.search(sd.chr_right) is None)
        self.strand.map = [c for c in self.strand.map
                           if rx.search(c.name) is None]
        self._rebase_strict()

    def flatten(self):
        """Collapse small fragments into the ``ASGART_COLLAPSED``
        pseudo-chromosome (structs.rs:350-415)."""
        if len(self.strand.map) < 2:
            return
        n = float(len(self.strand.map))
        lengths = [float(c.length) for c in self.strand.map]
        avg = sum(lengths) / n
        std = math.sqrt(
            1.0 / (n - 1.0) * sum((x - avg) ** 2 for x in lengths))

        to_flatten = [
            Start(c.name, c.position, c.length) for c in self.strand.map
            if float(c.length) <= avg + std and len(c.name) > 2
        ]
        to_flatten_len = sum(c.length for c in to_flatten)
        flatten_names = {c.name for c in to_flatten}
        to_keep = [
            Start(c.name, c.position, c.length) for c in self.strand.map
            if c.name not in flatten_names
        ]
        to_keep_len = sum(c.length for c in to_keep)

        i = 0
        for c in to_keep:
            c.position = i
            i += c.length
        for c in to_flatten:
            c.position = i
            i += c.length

        to_flatten_positions = {c.name: c.position for c in to_flatten}

        self.strand.map = to_keep
        self.strand.map.append(
            Start(COLLAPSED_NAME, to_keep_len + 1, to_flatten_len))

        for fam in self.families:
            for sd in fam:
                if sd.chr_left in flatten_names:
                    sd.chr_left_position += to_flatten_positions[sd.chr_left]
                    sd.chr_left = COLLAPSED_NAME
                if sd.chr_right in flatten_names:
                    sd.chr_right_position += to_flatten_positions[sd.chr_right]
                    sd.chr_right = COLLAPSED_NAME
