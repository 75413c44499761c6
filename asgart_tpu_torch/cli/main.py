"""``asgart`` CLI of the PyTorch port: find segmental duplications.

The flags are those of ``asgart_tpu.cli.main`` (``build_parser`` is a copy
of its own), with ``--engine`` choosing ``host`` or ``cuda``::

    python -m asgart_tpu_torch.cli.main genome.fa -R -C --engine cuda \\
        --out out.json

``--hosts N`` runs the ``--shards`` windows as worker processes of this
CLI, N at a time (``multihost.py``, as the JAX CLI does). Under
``torchrun`` (``WORLD_SIZE`` > 1 in the environment) with ``--engine
cuda`` each process is one rank of an NCCL group on ``cuda:LOCAL_RANK``
(``distributed.py``): the counterpart of one JAX process that sees every
device. Every rank computes the result; rank 0 alone writes ``--out``::

    torchrun --nproc-per-node 4 -m asgart_tpu_torch.cli.main genome.fa \\
        -R -C --engine cuda --out out.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import sys

from ..exporters import JSONExporter
from ..pipeline import search_duplications
from ..structs import RunSettings
from ..utils import make_out_filename


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="asgart",
        description="A Segmental duplications Gathering and Refinement Tool "
                    "(PyTorch / CUDA port)")
    p.add_argument("strands", nargs="*", help="The files to process")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="Increase verbosity (-v info, -vv debug, -vvv trace)")
    p.add_argument("--min-length", type=int, default=1000,
                   help="Minimal length (in bp) of the duplications to be "
                        "reported")
    p.add_argument("-k", "--probe-size", type=int, default=20,
                   help="Probing k-mers size")
    p.add_argument("-g", "--gap-size", type=int, default=100,
                   help="Maximum length of a gap")
    p.add_argument("-R", "--reverse", action="store_true",
                   help="Search for reversed duplications")
    p.add_argument("-C", "--complement", action="store_true",
                   help="Search for complemented duplications")
    p.add_argument("-S", "--skip-masked", action="store_true",
                   help="Ignore soft-masked repeated zones (lowercased)")
    p.add_argument("--trim", type=int, nargs=2, default=None,
                   help="Trim the first strand")
    p.add_argument("--max-cardinality", type=int, default=500,
                   help="Maximal cardinality of duplication families")
    p.add_argument("--prefix", default="",
                   help="Prefix to prepend to the default output file name")
    p.add_argument("--out", default=None, help="Set the output file name")
    p.add_argument("--compute-score", action="store_true",
                   help="Compute the Levenshtein distance between duplicons")
    p.add_argument("--threads", type=int, default=None,
                   help="Number of threads (host engine); default: cores")
    p.add_argument("--chunk-size", type=int, default=1000000,
                   help="(accepted for compatibility; unused, like the "
                        "reference)")
    p.add_argument("--engine", choices=["host", "cuda"], default="host",
                   help="Seed-lookup engine (host numpy or CUDA GPU)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="Journal completed chunks to FILE and resume from "
                        "it after a crash/preemption")
    p.add_argument("--shards", type=int, default=1, metavar="N",
                   help="Shard the index into N trim windows probed by "
                        "the whole genome and merged (the automated "
                        "version of the reference's --trim + asgart-slice "
                        "workflow; bounds index memory to 1/N)")
    p.add_argument("--hosts", type=int, default=1, metavar="N",
                   help="Run the --shards windows as worker PROCESSES, "
                        "up to N concurrently (the multi-host execution "
                        "form: one window per host, partial results "
                        "merged — zero cross-process communication). "
                        "Defaults --shards to N if unset")
    p.add_argument("--index-cache", default=None, metavar="DIR",
                   help="Cache the genome index in DIR keyed by input "
                        "hash; one cached index serves direct and R/C/RC "
                        "runs (host engine)")
    p.add_argument("--profile", action="store_true",
                   help="Print phase timings (JSON) to stderr")
    return p


def settings_from_args(args) -> RunSettings:
    """The run's settings from the parsed flags."""
    return RunSettings(
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


def _search_as_rank(args, settings, prof):
    """The search as one rank of a ``torchrun`` group (``WORLD_SIZE`` > 1
    in the environment): NCCL, with ``cuda:LOCAL_RANK`` as this rank's
    device."""
    from .. import distributed
    from ..device import cuda_device

    device = cuda_device(int(os.environ.get("LOCAL_RANK", "0")))
    distributed.init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     device, "env://", "nccl")
    try:
        return search_duplications(
            args.strands, settings, engine="cuda", device=device,
            checkpoint=args.checkpoint, shards=args.shards,
            index_cache=args.index_cache, profile=prof)
    finally:
        distributed.dist.destroy_process_group()


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

    settings = settings_from_args(args)
    prof: dict = {}
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if args.hosts > 1:
        if ranks > 1:
            raise ValueError("--hosts starts its own worker processes; run "
                             "it without torchrun")
        from ..multihost import search_duplications_multihost

        shards = args.shards if args.shards > 1 else args.hosts
        result = search_duplications_multihost(
            args.strands, settings, shards=shards, hosts=args.hosts,
            engine=args.engine)
    elif ranks > 1 and args.engine == "cuda":
        result = _search_as_rank(args, settings, prof)
    else:
        result = search_duplications(
            args.strands, settings, engine=args.engine,
            checkpoint=args.checkpoint, shards=args.shards,
            index_cache=args.index_cache, profile=prof)
    if args.profile:
        print(json.dumps(prof), file=sys.stderr)
    if int(os.environ.get("RANK", "0")) != 0 and ranks > 1:
        return 0  # every rank holds the result; rank 0 writes it

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
