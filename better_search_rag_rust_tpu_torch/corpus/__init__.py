"""Corpus walk and capped reads (:mod:`.walker`, with the native reader of
:mod:`..native`): sorted walk, 10 MB cap, pre-read stat identity."""

from .walker import (  # noqa: F401
    content_fingerprint,
    file_attr,
    file_stat,
    find_files_by_extensions,
    read_file,
    read_files,
)
