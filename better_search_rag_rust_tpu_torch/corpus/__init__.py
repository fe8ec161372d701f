"""Corpus walk and capped reads: the reference's own modules, shared.

``better_search_rag_rust_tpu.corpus.walker`` and its native (C++) reader
import no jax, so both packages walk, read and fingerprint files with one
implementation (sorted walk, 10 MB cap, pre-read stat identity).
"""

from better_search_rag_rust_tpu.corpus.walker import (  # noqa: F401
    content_fingerprint,
    file_attr,
    file_stat,
    find_files_by_extensions,
    read_file,
    read_files,
)
