"""Command-line interface of the port: ``search`` and ``evaluate``.

Both serve from a persisted store (the reference's ``SKIP_PROCESS=true``
mode) with the reference CLI's flags and output (``cli.py:475-517``); the
flag parsing and result printing are the reference's own, whose module
imports no jax. ``--device`` picks the card (default: CUDA when present).
The other reference subcommands (``run``, ``ingest``, ``serve``, ``update``,
``finetune``, ``bench``) belong to later slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from better_search_rag_rust_tpu.cli import (
    _add_common,
    _config_from_args,
    _print_result,
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="bsr-torch",
        description="exact top-k retrieval on one CUDA card (PyTorch port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, desc in [
        ("search", "serve search from the persisted store (SKIP_PROCESS=true)"),
        ("evaluate", "batch self-retrieval quality report on a built store"),
    ]:
        sp = sub.add_parser(name, help=desc)
        _add_common(sp)
        sp.add_argument("--device", default=None,
                        help="torch device (default: cuda when available)")
        if name == "evaluate":
            sp.add_argument("--num-queries", type=int, default=64)
    args = parser.parse_args(argv)
    if args.profile_dir or args.query is not None:
        flag = "--profile-dir" if args.profile_dir else "--query"
        raise NotImplementedError(
            f"{flag} is not ported to the PyTorch package yet (ROADMAP.md)")

    from .pipeline import Pipeline

    pipeline = Pipeline(_config_from_args(args, skip_process=True),
                        device=args.device)
    if args.command == "evaluate":
        print(json.dumps(pipeline.evaluate(args.num_queries, args.top_k)))
        print(pipeline.bench.generate_report())
        return 0
    _print_result(pipeline.run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
