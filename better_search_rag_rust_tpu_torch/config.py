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
