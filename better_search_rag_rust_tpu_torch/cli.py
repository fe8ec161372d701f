"""Command-line interface of the port: ``run``, ``ingest``, ``search`` and
``evaluate``.

The reference CLI's flags and output (``cli.py:381-517``); the flag parsing
and result printing are the reference's own, whose module imports no jax.
``run`` ingests the corpus, merges and then runs the self-retrieval search
(or, with ``--query TEXT``, retrieves the files matching the text);
``ingest`` stops after the merge; ``search`` and ``evaluate`` serve a
persisted store. ``--device`` names the torch device; the default is the
CUDA card, and without one the command fails (``--device cpu`` runs on the
CPU). The other reference subcommands (``serve``, ``update``, ``finetune``,
``bench``) and ``--snapshot`` / ``--profile-dir`` belong to later slices of
the port (ROADMAP.md).
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
        ("run", "full pipeline: ingest + merge + search + report"),
        ("ingest", "embed the corpus and persist the global store"),
        ("search", "serve search from the persisted store (SKIP_PROCESS=true)"),
        ("evaluate", "batch self-retrieval quality report on a built store"),
    ]:
        sp = sub.add_parser(name, help=desc)
        _add_common(sp)
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
        if name == "evaluate":
            sp.add_argument("--num-queries", type=int, default=64)
    args = parser.parse_args(argv)
    for flag, value in (("--profile-dir", args.profile_dir),
                        ("--snapshot", args.snapshot)):
        if value:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch package yet (ROADMAP.md)")

    from .pipeline import Pipeline

    cfg = _config_from_args(
        args, skip_process=args.command in ("search", "evaluate"))
    pipeline = Pipeline(cfg, device=args.device)
    if args.command == "evaluate":
        print(json.dumps(pipeline.evaluate(args.num_queries, args.top_k)))
        print(pipeline.bench.generate_report())
        return 0
    if args.command == "ingest":
        stats = pipeline.ingest_shard()
        pipeline.merge()
        print(f"ingested {stats.embeddings} embeddings from "
              f"{stats.files_read} files ({stats.files_skipped} skipped)")
        print(pipeline.bench.generate_report())
        return 0
    if args.query is not None:
        if args.command == "run":
            pipeline.ingest_shard()
            pipeline.merge()
        ranked = pipeline.query([args.query])[0]
        print(f"\nTop-{len(ranked)} files for query: {args.query!r}")
        for rank, (path, idx, dist) in enumerate(ranked, 1):
            print(f"  {rank:>3}. {path}  (row {idx}, dist {dist:.6f})")
        return 0
    _print_result(pipeline.run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
