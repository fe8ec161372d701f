"""better_search_rag_rust_tpu_torch — the exact top-k search path in PyTorch.

The PyTorch + CUDA port of :mod:`better_search_rag_rust_tpu`. The JAX package
stays the reference; this package mirrors its module names so each module's
counterpart is easy to find:

* :mod:`.store`    — Parquet read side and the one-device ``DeviceStore``
* :mod:`.ops`      — normalize/cast, the hand-written CUDA kernels
                     (:mod:`.ops.topk_kernels`), exact selection
                     (:mod:`.ops.topk`) and the ``SearchEngine``
* :mod:`.pipeline` — the serve-mode (``skip_process``) pipeline
* :mod:`.cli`      — ``search`` and ``evaluate`` subcommands

The package imports ``torch`` and never ``jax``. Every function that places
data takes an explicit ``device``.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
