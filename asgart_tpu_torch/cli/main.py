"""``asgart`` CLI of the PyTorch port: find segmental duplications.

The flags are those of ``asgart_tpu.cli.main`` (its ``build_parser``),
with ``--engine`` choosing ``host`` or ``cuda``::

    python -m asgart_tpu_torch.cli.main genome.fa -R -C --engine cuda \\
        --out out.json
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import sys

from asgart_tpu.cli.main import build_parser as _jax_parser
from asgart_tpu.exporters import JSONExporter
from asgart_tpu.structs import RunSettings
from asgart_tpu.utils import make_out_filename

from ..pipeline import ENGINES, search_duplications


def build_parser():
    p = _jax_parser()
    p.description = ("A Segmental duplications Gathering and Refinement "
                     "Tool (PyTorch / CUDA port)")
    for action in p._actions:
        if action.dest == "engine":
            action.choices = list(ENGINES)
            action.help = "Seed-lookup engine (host numpy or CUDA GPU)"
    return p


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level = [logging.WARNING, logging.INFO,
             logging.DEBUG][min(args.verbose, 2)]
    logging.basicConfig(level=level, format="%(levelname)s - %(message)s")
    if not args.strands:
        build_parser().print_help()
        return 1

    settings = RunSettings(
        probe_size=args.probe_size,
        max_gap_size=args.gap_size + args.probe_size,  # asgart.rs:681
        min_duplication_length=args.min_length,
        max_cardinality=args.max_cardinality,
        reverse=args.reverse,
        complement=args.complement,
        skip_masked=args.skip_masked,
        compute_score=args.compute_score,
        threads_count=args.threads or os.cpu_count() or 1,
        trim=tuple(args.trim) if args.trim else None,
    )
    prof: dict = {}
    result = search_duplications(
        args.strands, settings, engine=args.engine,
        checkpoint=args.checkpoint, shards=args.shards, hosts=args.hosts,
        index_cache=args.index_cache, profile=prof)
    if args.profile:
        print(json.dumps(prof), file=sys.stderr)

    if args.out is None:
        radix = "-".join(pathlib.Path(n).stem for n in args.strands)
        out_radix = "{}{}{}{}{}{}.json".format(
            args.prefix, radix,
            "_" if args.reverse or args.complement else "",
            "R" if args.reverse else "",
            "C" if args.complement else "",
            f"_{args.trim[0]}-{args.trim[1]}" if args.trim else "")
    else:
        out_radix = args.out
    out_filename = str(make_out_filename(out_radix, "", "json"))
    with open(out_filename, "w") as fh:
        JSONExporter().save(result, fh)
    print(f"Result written to {out_filename}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
