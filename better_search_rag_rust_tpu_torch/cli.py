"""Command-line interface of the port: ``run``, ``ingest``, ``search``,
``evaluate``, ``update``, ``serve`` and ``finetune``.

The reference CLI's flags and output (``cli.py:226-517``); the flag parsing
and result printing are in :mod:`.cli_args`. ``run`` ingests the corpus, merges and then runs the self-retrieval search
(or, with ``--query TEXT``, retrieves the files matching the text);
``ingest`` stops after the merge; ``search`` and ``evaluate`` serve a
persisted store; ``update`` reconciles the store with the edited tree;
``serve`` is the JSONL server over stdin/stdout or TCP (``--port``),
optionally through the micro-batcher (``--serve-window-ms``); ``finetune``
trains the encoder contrastively on pairs from the corpus, over a
``(world / tp, tp)`` mesh of the ranks; ``bench --suite NAME`` runs one
measurement suite of :mod:`.bench.suite` and prints its result
(``--json``: one JSON line). ``--snapshot`` keeps a device-store snapshot
for fast restarts. ``--profile-dir DIR`` on any subcommand writes a trace
of the whole command into ``DIR`` (:func:`.utils.profiling.device_trace`).
``--device`` names the torch device; the default is the CUDA card, and
without one the command fails (``--device cpu`` runs on the CPU).

Several processes: with the ``BSR_*`` env (:mod:`.launch`) ``main`` joins
the world before any work; ``run``, ``ingest``, ``search``, ``evaluate``
and ``update`` then run on every rank (each ingests its block, rank 0
merges, the store shards over the ranks) and only rank 0 prints;
``finetune`` trains on every rank (data- and tensor-parallel, ``--tp``) and
rank 0 prints and saves. ``serve`` and ``bench`` run one process.
"""

from __future__ import annotations

import argparse
import json
import sys
from contextlib import nullcontext
from typing import Optional, Sequence

from .cli_args import _add_common, _config_from_args, _print_result
from .parallel.mesh import process_info


def _single_process(command: str) -> None:
    """Refuse a multi-process world for a subcommand that runs one."""
    if process_info()[1] > 1:
        raise NotImplementedError(
            f"{command} runs in one process; launch it without "
            "BSR_COORDINATOR")


def serve_loop(pipeline, in_stream, out_stream, k=None, depth: int = 1,
               batcher=None) -> int:
    """Drive :meth:`..pipeline.Pipeline.serve` over line-delimited JSON (the
    reference's ``serve_loop``, ``cli.py:226-286``): one request per input
    line, one response per output line, flushed at once; malformed lines
    get an in-order error and blank lines are skipped. A reader thread
    feeds the requests, and whenever no line is ready a flush token makes
    the server answer everything in flight before it blocks on input — a
    synchronous client never waits on an answer the server is holding."""
    import queue
    import threading

    from .pipeline import MalformedRequest

    q: "queue.Queue" = queue.Queue()
    eof = object()

    def _reader():
        try:
            for line in in_stream:
                q.put(line)
        except (UnicodeDecodeError, OSError) as exc:
            q.put(MalformedRequest(f"unreadable input stream: {exc}"))
        finally:
            q.put(eof)

    threading.Thread(target=_reader, daemon=True).start()

    def _requests():
        while True:
            try:
                line = q.get(timeout=0.002)
            except queue.Empty:
                yield None  # flush: answer everything in flight, then block
                line = q.get()
            if line is eof:
                return
            if isinstance(line, MalformedRequest):
                yield line
                continue
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as exc:
                yield MalformedRequest(str(exc))

    for resp in pipeline.serve(_requests(), k=k, depth=depth, batcher=batcher):
        out_stream.write(json.dumps(resp) + "\n")
        out_stream.flush()
    return 0


def make_tcp_server(pipeline, host: str, port: int, k=None, depth: int = 1,
                    batcher=None):
    """A threading JSONL-over-TCP server, one :func:`serve_loop` per
    connection (the reference's ``make_tcp_server``). Returned unstarted:
    call ``serve_forever()``; ``server.server_address`` is the bound
    address (useful with port 0)."""
    import io
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            # undecodable bytes become U+FFFD: that line gets a
            # malformed-JSON answer, the connection lives on
            rin = io.TextIOWrapper(self.rfile, encoding="utf-8",
                                   errors="replace")
            wout = io.TextIOWrapper(self.wfile, encoding="utf-8",
                                    write_through=True)
            try:
                serve_loop(pipeline, rin, wout, k=k, depth=depth,
                           batcher=batcher)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away mid-stream

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((host, port), Handler)


def _serve(args) -> int:
    """``serve``: build the store on the device, then answer JSONL requests
    on stdin or on ``--host:--port`` (the reference's ``_serve``)."""
    from .pipeline import Pipeline

    _single_process("serve")
    cfg = _config_from_args(args, skip_process=True)
    pipeline = Pipeline(cfg, device=args.device)
    engine = pipeline.engine()  # the store is on the card before accepting
    where = (f"one JSON request per line on {args.host}:{args.port}"
             if args.port is not None else "one JSON request per line on stdin")
    batcher = None
    if args.serve_window_ms > 0:
        from .batcher import DynamicBatcher

        batcher = DynamicBatcher(
            engine, k=args.top_k, max_batch=args.serve_max_batch,
            window_ms=args.serve_window_ms, upload=cfg.search.query_upload)
    print(f"serving {engine.store.num_rows} rows (top_k={args.top_k}, "
          f"kernel={engine.kernel_name()}, depth={args.serve_depth}"
          + (f", batch window {args.serve_window_ms} ms" if batcher else "")
          + f"); {where}", file=sys.stderr, flush=True)
    try:
        sys.stdin.reconfigure(errors="replace")
    except (AttributeError, ValueError):
        pass
    try:
        if args.port is not None:
            with make_tcp_server(pipeline, args.host, args.port, k=args.top_k,
                                 depth=args.serve_depth,
                                 batcher=batcher) as server:
                print(f"listening on {server.server_address[0]}:"
                      f"{server.server_address[1]}", file=sys.stderr,
                      flush=True)
                try:
                    server.serve_forever()
                except KeyboardInterrupt:
                    pass
            return 0
        return serve_loop(pipeline, sys.stdin, sys.stdout, k=args.top_k,
                          depth=args.serve_depth, batcher=batcher)
    finally:
        if batcher is not None:
            batcher.close()


def _finetune(args) -> int:
    """Contrastive fine-tuning on corpus pairs: the reference's
    ``_finetune`` (``cli.py:169-223``) over a ``(data, model)`` mesh of the
    world's ranks, one shard a rank, ``--tp`` of them on the model axis.
    Every rank reads the same pairs (each trains on its data block); rank
    0 prints and writes ``--save-dir``."""
    from .models.nomic import NomicBertConfig, load_hf_checkpoint
    from .models.tokenizer import load_tokenizer
    from .models.train import ContrastiveTrainer
    from .models.train_data import corpus_pair_batches
    from .parallel.mesh import create_mesh
    from .utils.device import resolve_device

    rank, world = process_info()
    tp = max(1, args.tp)
    if world % tp:
        raise SystemExit(f"--tp {tp} does not divide {world} devices")
    cfg = _config_from_args(args, skip_process=True)
    enc_cfg = cfg.encoder
    model_cfg = NomicBertConfig.from_encoder_config(enc_cfg)
    params = None
    if enc_cfg.checkpoint_dir:
        model_cfg, params = load_hf_checkpoint(enc_cfg.checkpoint_dir,
                                               model_cfg)
    mesh = create_mesh((world // tp, tp), ("data", "model"),
                       devices=[resolve_device(args.device)])
    trainer = ContrastiveTrainer(model_cfg, learning_rate=args.learning_rate,
                                 params=params, mesh=mesh)
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
        if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:>5}  loss {loss:.4f}")
    if not losses:
        if rank == 0:
            print("no training steps ran (--steps must be positive)")
        return 1
    if args.save_dir:
        trainer.save(args.save_dir)
        if rank == 0:
            print(f"params saved to {args.save_dir}")
    if rank == 0:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="bsr-torch",
        description="exact top-k retrieval on CUDA cards (PyTorch port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, desc in [
        ("run", "full pipeline: ingest + merge + search + report"),
        ("ingest", "embed the corpus and persist the global store"),
        ("search", "serve search from the persisted store (SKIP_PROCESS=true)"),
        ("evaluate", "batch self-retrieval quality report on a built store"),
        ("update", "incrementally embed corpus files not yet in the store"),
    ]:
        sp = sub.add_parser(name, help=desc)
        _add_common(sp)
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
        if name == "evaluate":
            sp.add_argument("--num-queries", type=int, default=64)
    sv = sub.add_parser(
        "serve", help="persistent JSONL search server: one request per stdin "
                      "line, one response per stdout line")
    _add_common(sv)
    sv.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    sv.add_argument("--serve-depth", type=int, default=1,
                    help="requests kept in flight on the device before "
                         "results are pulled (1 = synchronous)")
    sv.add_argument("--port", type=int, default=None,
                    help="listen for JSONL connections on this TCP port "
                         "instead of stdin/stdout (0 = ephemeral)")
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address for --port")
    sv.add_argument("--serve-window-ms", type=float, default=0.0,
                    help="dynamic micro-batching: coalesce requests landing "
                         "within this window (across all connections) into "
                         "one dispatch; 0 disables")
    sv.add_argument("--serve-max-batch", type=int, default=1024,
                    help="max coalesced query rows per dispatch when "
                         "--serve-window-ms is on")
    ft = sub.add_parser(
        "finetune", help="contrastive fine-tuning of the encoder on the corpus")
    _add_common(ft)
    ft.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ft.add_argument("--steps", type=int, default=50)
    ft.add_argument("--learning-rate", type=float, default=2e-5)
    ft.add_argument("--train-batch", type=int, default=32)
    ft.add_argument("--tp", type=int, default=1,
                    help="model (tensor-parallel) mesh axis size")
    ft.add_argument("--save-dir", default=None,
                    help="checkpoint dir for the tuned params")
    bp = sub.add_parser("bench", help="performance benchmark suite")
    bp.add_argument("--suite", default="search_1m",
                    help="benchmark config name (see bench/suite.py)")
    bp.add_argument("--json", action="store_true", dest="as_json")
    bp.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a device trace of the run into DIR")
    bp.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from .launch import maybe_init_distributed

    # the world this call joins, it leaves; one its caller joined stays
    joined = not dist.is_initialized() and maybe_init_distributed()
    try:
        return _traced(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _traced(args) -> int:
    if args.profile_dir:
        from .utils.profiling import device_trace

        trace = device_trace(args.profile_dir)
    else:
        trace = nullcontext()
    with trace:
        return _run_command(args)


def _run_command(args) -> int:
    if args.command == "bench":
        from .bench.suite import run_suite

        _single_process("bench")
        result = run_suite(args.suite, device=args.device)
        print(json.dumps(result) if args.as_json else result)
        return 0
    if args.command == "finetune":
        return _finetune(args)
    if args.command == "serve":
        return _serve(args)

    from .pipeline import Pipeline

    cfg = _config_from_args(
        args, skip_process=args.command in ("search", "evaluate", "update"))
    pipeline = Pipeline(cfg, device=args.device)
    # every rank computes (searches and the report are collectives); rank 0
    # prints
    root = process_info()[0] == 0
    if args.command == "evaluate":
        report = pipeline.evaluate(args.num_queries, args.top_k)
        bench = pipeline.bench.generate_report()
        if root:
            print(json.dumps(report))
            print(bench)
        return 0
    if args.command == "update":
        stats = pipeline.update()
        if root:
            print(f"appended {stats.embeddings} embeddings, re-embedded "
                  f"{stats.rows_reembedded}, deleted {stats.rows_deleted} "
                  f"({stats.files_assigned} new files, "
                  f"{stats.files_skipped} skipped)")
        return 0
    if args.command == "ingest":
        stats = pipeline.ingest_shard()
        pipeline.merge()
        bench = pipeline.bench.generate_report()
        if root:
            print(f"ingested {stats.embeddings} embeddings from "
                  f"{stats.files_read} files ({stats.files_skipped} skipped)")
            print(bench)
        return 0
    if args.query is not None:
        if args.command == "run":
            pipeline.ingest_shard()
            pipeline.merge()
        ranked = pipeline.query([args.query])[0]
        if root:
            print(f"\nTop-{len(ranked)} files for query: {args.query!r}")
            for rank, (path, idx, dist) in enumerate(ranked, 1):
                print(f"  {rank:>3}. {path}  (row {idx}, dist {dist:.6f})")
        return 0
    result = pipeline.run()
    if root:
        _print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
