"""Embedding models: the NomicBERT encoder (on the K8 attention kernel), the
hermetic hash encoder, their tokenizers and the encoder service; training
(``train``, ``train_data``, ``checkpoint``: the contrastive trainer on K8
and K9) is imported from its modules.

Counterpart of ``better_search_rag_rust_tpu/models`` (its multi-device
trainer is a later slice of the port).
"""

from .encoder import EncoderService, create_encoder  # noqa: F401
from .hash_encoder import HashEncoder  # noqa: F401
from .nomic import NomicBertConfig, NomicBertModel, NomicEncoder  # noqa: F401
from .tokenizer import (  # noqa: F401
    FixedLengthTokenizer,
    HashingTokenizer,
    load_tokenizer,
)
