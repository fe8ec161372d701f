"""Command-line interface of the port: ``run``, ``ingest``, ``search``,
``evaluate`` and ``finetune``.

The reference CLI's flags and output (``cli.py:381-517``); the flag parsing
and result printing are the reference's own, whose module imports no jax.
``run`` ingests the corpus, merges and then runs the self-retrieval search
(or, with ``--query TEXT``, retrieves the files matching the text);
``ingest`` stops after the merge; ``search`` and ``evaluate`` serve a
persisted store; ``finetune`` trains the encoder contrastively on pairs
from the corpus (one device; ``--tp`` above 1 is the multi-GPU slice).
``--device`` names the torch device; the default is the CUDA card, and
without one the command fails (``--device cpu`` runs on the CPU). The other
reference subcommands (``serve``, ``update``, ``bench``) and ``--snapshot``
/ ``--profile-dir`` belong to later slices of the port (ROADMAP.md).
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


def _finetune(args) -> int:
    """Contrastive fine-tuning on corpus pairs: the reference's
    ``_finetune`` (``cli.py:169-223``) on one device."""
    from .models.nomic import NomicBertConfig, load_hf_checkpoint
    from .models.tokenizer import load_tokenizer
    from .models.train import ContrastiveTrainer
    from .models.train_data import corpus_pair_batches

    if args.tp > 1:
        raise NotImplementedError(
            f"--tp {args.tp}: tensor parallelism is the multi-GPU slice of "
            "the port (ROADMAP.md, Queue 1 item 11); the port trains on one "
            "device")
    cfg = _config_from_args(args, skip_process=True)
    enc_cfg = cfg.encoder
    model_cfg = NomicBertConfig.from_encoder_config(enc_cfg)
    params = None
    if enc_cfg.checkpoint_dir:
        model_cfg, params = load_hf_checkpoint(enc_cfg.checkpoint_dir,
                                               model_cfg)
    trainer = ContrastiveTrainer(model_cfg, learning_rate=args.learning_rate,
                                 params=params, device=args.device)
    tokenizer = load_tokenizer(enc_cfg.checkpoint_dir, enc_cfg.max_tokens,
                               enc_cfg.vocab_size)
    batches = corpus_pair_batches(
        cfg.corpus.root, cfg.corpus.extensions, tokenizer, args.train_batch,
        max_file_bytes=cfg.corpus.max_file_bytes,
        epochs=10_000,  # bounded by --steps below
    )
    losses = []
    for step, (a_ids, a_mask, p_ids, p_mask) in enumerate(batches):
        if step >= args.steps:
            break
        loss = trainer.train_step(a_ids, a_mask, p_ids, p_mask)
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:>5}  loss {loss:.4f}")
    if not losses:
        print("no training steps ran (--steps must be positive)")
        return 1
    if args.save_dir:
        from .models.checkpoint import save_params

        save_params(args.save_dir, trainer.state.params)
        print(f"params saved to {args.save_dir}")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return 0


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
    ft = sub.add_parser(
        "finetune", help="contrastive fine-tuning of the encoder on the corpus")
    _add_common(ft)
    ft.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ft.add_argument("--steps", type=int, default=50)
    ft.add_argument("--learning-rate", type=float, default=2e-5)
    ft.add_argument("--train-batch", type=int, default=32)
    ft.add_argument("--tp", type=int, default=1,
                    help="model (tensor-parallel) axis size; only 1 is "
                         "ported")
    ft.add_argument("--save-dir", default=None,
                    help="checkpoint dir for the tuned params")
    args = parser.parse_args(argv)
    for flag, value in (("--profile-dir", args.profile_dir),
                        ("--snapshot", args.snapshot)):
        if value:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch package yet (ROADMAP.md)")
    if args.command == "finetune":
        return _finetune(args)

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
