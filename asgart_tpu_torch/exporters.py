"""Result exporters: JSON (the format), GFF2, GFF3.

Byte-compatible with the reference (``src/exporters.rs``):
  * JSON: serde_json pretty + trailing newline (exporters.rs:14-24),
  * GFF2: two lines per SD, track header, identity×100 (exporters.rs:28-67),
  * GFF3: 1-based coordinates, sequence-region headers (exporters.rs:70-113).

GFF float fields use Rust ``Display`` formatting for f32 (shortest
round-trip, fixed notation, no forced ``.0``).
"""

from __future__ import annotations

import numpy as np

from .json_io import save_json
from .structs import RunResult


def format_f32_display(v: float) -> str:
    """Rust ``{}`` (Display) for f32: shortest round-trip decimal in fixed
    notation; integral values print without a decimal part (``0``, ``50``)."""
    v32 = np.float32(v)
    if v32 == 0.0:
        return "-0" if np.signbit(v32) else "0"
    for prec in range(1, 10):
        s = np.format_float_scientific(
            v32, precision=prec - 1, unique=False, trim="-")
        if np.float32(s) == v32:
            break
    mant, exp = s.split("e")
    e10 = int(exp)
    neg = mant.startswith("-")
    if neg:
        mant = mant[1:]
    digits = mant.replace(".", "").rstrip("0") or "0"
    ndig = len(digits)
    point = e10 + 1
    if point <= 0:
        body = "0." + "0" * (-point) + digits
    elif point >= ndig:
        body = digits + "0" * (point - ndig)
    else:
        body = digits[:point] + "." + digits[point:]
    return ("-" if neg else "") + body


class JSONExporter:
    def save(self, result: RunResult, out) -> None:
        save_json(result.to_json_obj(), out)


class GFF2Exporter:
    def save(self, result: RunResult, out) -> None:
        out.write(
            "track name=Duplications\tuseScore=1\t"
            f'description="ASGART - {result.strand.name}"\n')
        for i, family in enumerate(result.families):
            for j, sd in enumerate(family):
                chr_left = sd.chr_left.strip().replace(" ", "_")
                chr_right = sd.chr_right.strip().replace(" ", "_")
                identity = format_f32_display(
                    np.float32(sd.identity) * np.float32(100.0))
                out.write(
                    f"{chr_left}\tASGART\tSD\t{sd.chr_left_position}\t"
                    f"{sd.chr_left_position + sd.left_length}\t#{identity}\t"
                    f"+\t.\tSD#{i}/{j}-{chr_left}\n")
                reverse = "-" if sd.reversed else "+"
                out.write(
                    f"{chr_right}\tASGART\tSD\t{sd.chr_right_position}\t"
                    f"{sd.chr_right_position + sd.right_length}\t#{identity}\t"
                    f"#{reverse}\t.\tSD#{i}/{j}-{chr_right}\n")
            out.write("\n")


class GFF3Exporter:
    def save(self, result: RunResult, out) -> None:
        out.write("##gff-version 3.2.1\n")
        for chr_ in result.strand.map:
            out.write(
                f"##sequence-region {chr_.name} {chr_.position + 1} "
                f"{chr_.position + chr_.length + 1}\n")
        for i, family in enumerate(result.families):
            for j, sd in enumerate(family):
                chr_left = sd.chr_left.strip().replace(" ", "_")
                chr_right = sd.chr_right.strip().replace(" ", "_")
                identity = format_f32_display(sd.identity)
                out.write(
                    f"{chr_left}\tASGART\tSD\t{sd.chr_left_position + 1}\t"
                    f"{sd.chr_left_position + sd.left_length + 1}\t{identity}\t"
                    f"+\t.\tID=SD#{i}-{j};Name=SD#{i}-{j}\n")
                reverse = "-" if sd.reversed else "+"
                out.write(
                    f"{chr_right}\tASGART\tSD\t{sd.chr_right_position + 1}\t"
                    f"{sd.chr_right_position + sd.right_length + 1}\t{identity}\t"
                    f"{reverse}\t.\tID=SD#{i}-{j}-right;Parent=SD#{i}-{j};"
                    f"Name=SD#{i}-{j}\n")
            out.write("\n")
