"""better_search_rag_rust_tpu_torch — the system in PyTorch on one CUDA card.

The PyTorch + CUDA port of :mod:`better_search_rag_rust_tpu`. The JAX package
stays the reference; this package mirrors its module names so each module's
counterpart is easy to find:

* :mod:`.store`    — the Parquet store and the one-device ``DeviceStore``
* :mod:`.ops`      — normalize/cast, the hand-written CUDA kernels
                     (:mod:`.ops.topk_kernels`, :mod:`.ops.attention_kernels`),
                     exact selection (:mod:`.ops.topk`) and the
                     ``SearchEngine``
* :mod:`.models`   — tokenizers, NomicBERT, the encoder service and the
                     contrastive trainer (:mod:`.models.train`)
* :mod:`.pipeline` — build and serve mode
* :mod:`.cli`      — ``run``, ``ingest``, ``search``, ``evaluate`` and
                     ``finetune``

The package imports ``torch`` and never ``jax``. Every function that places
data takes an explicit ``device``.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
