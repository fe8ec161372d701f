"""Flags and result printing shared by the CLI's subcommands.

The port's copy of ``_add_common``, ``_config_from_args`` and
``_print_result`` of ``better_search_rag_rust_tpu/cli.py`` (:36-166): the
same flags, defaults and output, so a command line drives either package
alike. ``--search-kernel`` also answers to ``--kernel``.
"""

from __future__ import annotations

import argparse

from .config import (
    CorpusConfig,
    EncoderConfig,
    MeshConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)


def _add_common(p: argparse.ArgumentParser) -> None:
    corp = p.add_argument_group("corpus")
    corp.add_argument("--root", default=".repos/jabref",
                      help="corpus directory (reference: src/main.rs:39)")
    corp.add_argument("--extensions", default="java",
                      help="comma-separated extensions (src/main.rs:38)")
    corp.add_argument("--files-per-batch", type=int, default=32,
                      help="files per embedding batch (src/main.rs:40)")
    corp.add_argument("--max-file-mb", type=float, default=10.0,
                      help="per-file read cap in MB (src/source.rs:36-39)")

    enc = p.add_argument_group("encoder")
    enc.add_argument("--encoder-backend", default="auto",
                     choices=["auto", "nomic", "hash"])
    enc.add_argument("--checkpoint-dir", default=None,
                     help="local HF export of nomic-embed-text-v1.5")
    enc.add_argument("--dim", type=int, default=768)
    enc.add_argument("--max-tokens", type=int, default=512)
    enc.add_argument("--encode-batch-size", type=int, default=32)
    enc.add_argument("--num-layers", type=int, default=12)
    enc.add_argument("--num-heads", type=int, default=12)
    enc.add_argument("--mlp-dim", type=int, default=3072)
    enc.add_argument("--matryoshka-dim", type=int, default=None,
                     help="truncate embeddings to this dim and re-normalize")
    enc.add_argument("--long-doc", default="truncate",
                     choices=["truncate", "mean"],
                     help="long files: drop past max-tokens (reference "
                          "semantics) or window + mean-pool everything")

    st = p.add_argument_group("store")
    st.add_argument("--store-dir", default=".volumes/vstore",
                    help="vector store directory (src/main.rs:41)")
    st.add_argument("--snapshot", action="store_true",
                    help="maintain a device-store snapshot for fast serve "
                         "startup")
    st.add_argument("--force-merge", action="store_true",
                    help="let a merge rebuild global.parquet even when an "
                         "incremental update left it ahead of the shards "
                         "(the appended rows are DISCARDED; only safe after "
                         "a full re-ingest)")

    srch = p.add_argument_group("search")
    srch.add_argument("--top-k", type=int, default=50,
                      help="(src/main.rs:110)")
    srch.add_argument("--query-idx", type=int, default=0,
                      help="self-retrieval query row (src/main.rs:111)")
    srch.add_argument("--store-dtype", default="bfloat16",
                      choices=["bfloat16", "float32"])
    srch.add_argument("--chunk-rows", type=int, default=16384)
    srch.add_argument("--search-kernel", "--kernel", dest="search_kernel",
                      default="auto",
                      choices=["auto", "global", "scan", "blockmax", "pallas",
                               "rescore", "f32cert"])
    srch.add_argument("--rescore-argmax", default="auto",
                      choices=["auto", "off"],
                      help="argmax fast path of the rescore kernel "
                           "(candidates from in-kernel unit argmaxes; "
                           "only danger units gathered)")
    srch.add_argument("--danger-units", type=int, default=4,
                      help="per-query danger-unit gather capacity for the "
                           "argmax fast path")
    srch.add_argument("--query-upload", default="f32",
                      choices=["f32", "store"],
                      help="streaming/serve query upload: 'store' rounds "
                           "queries to the store dtype on the host and "
                           "uploads half the bytes (bf16 stores)")
    srch.add_argument("--query", default=None, metavar="TEXT",
                      help="free-text query: encode and retrieve matching "
                           "corpus files instead of the self-retrieval check")

    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a device trace of the run into DIR (Chrome "
                        "trace JSON, torch.profiler)")
    p.add_argument("--speedup-baseline", action="store_true",
                   help="also measure a sequential NumPy scan and print "
                        "speedup in the benchmark report (reference: "
                        "benchmark.rs:361-416; pulls the store to the host)")


def _config_from_args(args, skip_process: bool) -> PipelineConfig:
    return PipelineConfig(
        corpus=CorpusConfig(
            root=args.root,
            extensions=tuple(
                e.strip() for e in args.extensions.split(",") if e.strip()
            ),
            max_file_bytes=int(args.max_file_mb * 1024 * 1024),
            files_per_batch=args.files_per_batch,
        ),
        encoder=EncoderConfig(
            backend=args.encoder_backend,
            checkpoint_dir=args.checkpoint_dir,
            dim=args.dim,
            max_tokens=args.max_tokens,
            batch_size=args.encode_batch_size,
            num_layers=args.num_layers,
            num_heads=args.num_heads,
            mlp_dim=args.mlp_dim,
            matryoshka_dim=args.matryoshka_dim,
            long_doc=args.long_doc,
        ),
        store=StoreConfig(dir=args.store_dir, use_snapshot=args.snapshot),
        mesh=MeshConfig(),
        search=SearchConfig(
            top_k=args.top_k,
            query_idx=args.query_idx,
            store_dtype=args.store_dtype,
            chunk_rows=args.chunk_rows,
            kernel=args.search_kernel,
            rescore_argmax=getattr(args, "rescore_argmax", "auto"),
            danger_units=getattr(args, "danger_units", 4),
            query_upload=getattr(args, "query_upload", "f32"),
        ),
        skip_process=skip_process,
        measure_serial_baseline=getattr(args, "speedup_baseline", False),
        force_merge=getattr(args, "force_merge", False),
    )


def _print_result(result) -> None:
    # ≙ print_top_k_results + accuracy print (reference: src/main.rs:142-163,
    # src/mpi_helpers/metrics.rs:209-214)
    print(f"\nTop-{len(result.top_k)} results (store row, cosine distance):")
    for rank, (idx, dist) in enumerate(result.top_k[:10], 1):
        print(f"  {rank:>3}. row {idx:>8}  dist {dist:.6f}")
    if len(result.top_k) > 10:
        print(f"  ... ({len(result.top_k) - 10} more)")
    print(
        f"\nAccuracy: MRR={result.mrr:.4f} "
        f"Recall@k={result.recall:.4f} overlap={result.overlap:.4f}"
    )
    print(result.report)
