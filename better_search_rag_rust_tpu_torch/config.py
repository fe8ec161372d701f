"""Configuration surface of the port.

The same six dataclasses as ``better_search_rag_rust_tpu/config.py``, field
for field — names, order and defaults — so a config built by either package
drives the other (the tests hand the JAX package's configs to the port and
check the fields agree). Every knob the reference hardcodes
(src/main.rs:38-45, src/llm/hf.rs:9-10,62) is a field here with a CLI
mapping (:mod:`.cli_args`). Fields that only the JAX package reads (the
TPU planner overrides) are kept so configs stay interchangeable.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Default embedding dimensionality of nomic-embed-text-v1.5
# (reference: src/llm/hf.rs:118-123 — [B, 768] output).
DEFAULT_DIM = 768
# Fixed tokenization length (reference: src/llm/hf.rs:62 — max_token_length=512,
# PaddingStrategy::Fixed(512)).
DEFAULT_MAX_TOKENS = 512
# 10 MB file-read cap (reference: src/source.rs:36-39).
DEFAULT_MAX_FILE_BYTES = 10 * 1024 * 1024


@dataclass(frozen=True)
class CorpusConfig:
    """Which files to ingest (reference: src/main.rs:38-39, src/source.rs:8-49)."""

    root: str = ".repos/jabref"
    extensions: Tuple[str, ...] = ("java",)
    max_file_bytes: int = DEFAULT_MAX_FILE_BYTES
    #: Files per embedding batch ("chunk" in the reference = a batch of files,
    #: reference: src/main.rs:40, src/mpi_helpers/tasks.rs:80-83).
    files_per_batch: int = 32
    #: Max embedding batches dispatched to the device but not yet collected
    #: in the ingest pipeline (2 = dispatch i, collect i-1).
    inflight_batches: int = 2


@dataclass(frozen=True)
class EncoderConfig:
    """Embedding model spec (reference: src/llm/hf.rs).

    ``checkpoint_dir`` may point at a local HF-format export of
    ``nomic-ai/nomic-embed-text-v1.5`` (config.json + weights + tokenizer).
    When absent, the framework falls back to a deterministic hash encoder so
    the full pipeline stays runnable hermetically.
    """

    name: str = "nomic-embed-text-v1.5"
    checkpoint_dir: Optional[str] = None
    dim: int = DEFAULT_DIM
    max_tokens: int = DEFAULT_MAX_TOKENS
    # NomicBERT architecture defaults (BERT-base sized backbone).
    vocab_size: int = 30528
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    type_vocab_size: int = 2
    rotary_base: float = 1000.0
    layer_norm_eps: float = 1e-12
    #: "swiglu" (NomicBERT) or "gelu" (classic BERT).
    activation: str = "swiglu"
    #: Mean pooling over the attention mask, then L2-normalize.
    pooling: str = "mean"
    #: Matryoshka truncation: keep the first ``matryoshka_dim`` dims and
    #: re-normalize (v1.5 is Matryoshka-trained). None = full ``dim``.
    matryoshka_dim: Optional[int] = None
    #: Compute dtype for the forward pass.
    dtype: str = "bfloat16"
    #: Attention implementation: "auto" and "fused" run the fused attention
    #: kernel (K8, up to 1,024 tokens), "xla" the plain chain with f32
    #: logits, "xla_bf16" the plain chain with bf16 logits, "flash" the
    #: flash kernels (K14-K16: long contexts, max_tokens a multiple of 128).
    attention_impl: str = "auto"
    #: Long-document handling: "truncate" keeps the reference's semantics
    #: (text beyond max_tokens is dropped, src/llm/hf.rs:62-67); "mean"
    #: encodes every fixed-shape window and mean-pools per document.
    long_doc: str = "truncate"
    #: Batch size of the forward (fixed shape).
    batch_size: int = 32
    #: "nomic" = the NomicBERT model (random-init unless checkpoint_dir is
    #: set), "hash" = deterministic hash encoder (hermetic tests/benches).
    backend: str = "auto"


@dataclass(frozen=True)
class StoreConfig:
    """Persistent vector store (reference: src/vectorstore/polars.rs, parquet
    shards ``rank_{r}.parquet`` merged into ``global.parquet`` —
    src/mpi_helpers/vectorstore.rs:5-20)."""

    dir: str = ".volumes/vstore"
    #: On-disk dtype. float32 matches the reference's List<f32> column.
    dtype: str = "float32"
    #: Maintain a snapshot of the built device store next to the Parquet
    #: store and serve from it when fresh (see store/device_cache.py).
    use_snapshot: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh topology (reference: MPI world/rank/size,
    src/main.rs:27-30): ``Pipeline.mesh`` shards the device store over it
    (``parallel/mesh.py``; ``shape=None``: one shard per device)."""

    shape: Optional[Tuple[int, ...]] = None
    axis_names: Tuple[str, ...] = ("data",)


@dataclass(frozen=True)
class SearchConfig:
    """Exact top-k search (reference: src/mpi_helpers/metrics.rs:16-206)."""

    top_k: int = 50
    #: Index of the stored vector used as the self-retrieval query
    #: (reference: src/main.rs:110-111).
    query_idx: int = 0
    #: Store rows scanned per scan step (the JAX package's scan routes).
    chunk_rows: int = 16384
    #: Column-block size for the hierarchical (block-max) selection.
    row_block: int = 128
    #: dtype the store is held in on the device: "bfloat16" (default —
    #: exact vs the bf16-rounded oracle), "float32" (exact vs the f32
    #: oracle), or "int8" (symmetric lattice quantization; exact vs the
    #: integer oracle — see ops/quantize.py).
    store_dtype: str = "bfloat16"
    #: Cap on the f32 similarity buffer of the dense route (0 = auto).
    sims_buffer_bytes: int = 0
    #: Planner device-profile overrides of the JAX package (0 / "" = auto);
    #: exactness never depends on them. The port does not read them.
    device_kind: str = ""
    hbm_gb: float = 0.0
    hbm_gbps: float = 0.0
    slice_ns: float = 0.0
    final_topk_us: float = 0.0
    #: Search route: "global" (dense two-stage block selection), "pallas"
    #: (the dense route's name for its fused kernel), "rescore" (sims-free:
    #: unit-maxima pass + rescore of the selected units), "f32cert"
    #: (certified two-stage route for f32 stores: selection, gathered-row
    #: rescore, and an exactness certificate with a dense fallback),
    #: "scan"/"blockmax" (chunked comparison routes), or "auto" (pick by
    #: shard size / dim / dtype / k).
    kernel: str = "auto"
    #: Certified f32 route: "auto" (the backend's rule), "on" (force it for
    #: f32 stores at k <= 128 — tests drive both certificate branches with
    #: it), "off". Exactness never depends on this knob: the route falls
    #: back to the dense branch wherever its certificate fails.
    f32_certified: str = "auto"
    #: Argmax fast path of the rescore route: the unit-maxima pass also
    #: emits each unit's argmax and second max, so only "danger" units
    #: (a second row could be top-k) are rescored, up to ``danger_units``
    #: per query, with a fallback to the full gather. "auto" = on, "off" =
    #: always the full gather. Exactness never depends on the choice.
    rescore_argmax: str = "auto"
    #: Danger-unit capacity per query for the argmax fast path.
    danger_units: int = 4
    #: Danger-gather units per grid step of the JAX kernel (0 = auto).
    danger_cpg: int = 0
    #: Superblock group width for the rescore selection (groups = sup_w
    #: blocks when the store is large enough).
    rescore_sup_w: int = 8
    #: Query upload dtype for the streaming/serving paths: "f32" uploads
    #: f32 queries and rounds to the store dtype on the device (default);
    #: "store" normalizes and rounds on the host and uploads store-dtype
    #: bits — half the host->device bytes on bf16 stores, a quarter on
    #: int8. Both are exact against the oracle fed their own query bits.
    query_upload: str = "f32"


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline (reference: src/main.rs:25-189)."""

    corpus: CorpusConfig = field(default_factory=CorpusConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    #: Skip ingest+embed and serve search from the persisted global store
    #: (reference: SKIP_PROCESS env, src/main.rs:42-45).
    skip_process: bool = False
    #: Resume a partially completed ingest from the shard's progress marker.
    resume: bool = False
    #: Persist the shard store + progress marker every N batches during
    #: ingest (0 = only at the end, the reference's behavior).
    checkpoint_every_batches: int = 16
    #: Measure a sequential NumPy scan of the same search and feed it to the
    #: benchmark report's speedup hook (reference:
    #: src/mpi_helpers/benchmark.rs:361-416). Pulls the store to the host.
    measure_serial_baseline: bool = False
    #: Let a merge rebuild global.parquet even when an incremental
    #: ``update()`` left it AHEAD of the per-shard stores (the appended rows
    #: are discarded by the rebuild). Default False: merge fails loudly.
    force_merge: bool = False
    #: Let the merge publish a global store with missing/unreadable shards
    #: (recorded in a ``global.parquet.partial`` marker). Default False.
    allow_partial_merge: bool = False

    @staticmethod
    def from_env() -> "PipelineConfig":
        """Honour the reference's env knobs (src/main.rs:42-45) on top of
        defaults."""
        skip = os.environ.get("SKIP_PROCESS", "").lower() in ("1", "true", "yes")
        return PipelineConfig(skip_process=skip)

    def replace(self, **kwargs) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def torch_dtype(name):
    """A config dtype name ("bfloat16", "float32", "float16") or a dtype ->
    the torch dtype."""
    import torch

    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
