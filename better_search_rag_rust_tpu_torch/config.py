"""Configuration: the reference's dataclasses, shared as they are.

``better_search_rag_rust_tpu.config`` imports nothing but the standard
library, so both packages read one configuration surface and a config built
for one drives the other.
"""

from better_search_rag_rust_tpu.config import (  # noqa: F401
    CorpusConfig,
    EncoderConfig,
    MeshConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
    asdict,
)


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
