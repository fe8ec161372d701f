"""The normalized embedding store, resident on one device.

Counterpart of ``better_search_rag_rust_tpu/store/device_store.py`` on one
card. Rows are L2-normalized in float32 with the zero-magnitude guard, then
rounded to the store dtype (bf16 by default, float32, or the int8 lattice of
:mod:`..ops.quantize`) — what the kernels score.

Layout: ``data [padded_rows, dim]``, row-major and contiguous. The JAX store
pads features to the TPU's 128 lanes; that padding is gone here. Rows are
padded with zero rows to a multiple of :data:`ROW_ALIGN`, the widest row
block the selection routes tile by, so no route ever copies the store to pad
it. Padded rows are masked to ``PAD_SIM`` inside the kernels and can never
displace a valid row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.distance import normalize_rows
from ..ops.quantize import cast_rows_to, store_dtype
from ..parallel.partition import pad_to_multiple

#: Row padding multiple: the rescore route's widest row block (1024 rows at
#: the low-dim geometry) and a multiple of every kernel's 128-row tile.
ROW_ALIGN = 1024
#: Rows normalized per step when a store is built, bounding the f32
#: intermediate (~400 MB at 768-d) next to the store.
_BUILD_ROWS = 1 << 17


def check_row_capacity(padded_rows: int) -> None:
    """Row ids travel through the selection as int32; refuse stores whose
    padded row space would overflow that rather than wrap at scale."""
    if padded_rows >= 2**31:
        raise ValueError(
            f"store has {padded_rows} padded rows, which overflows the int32 "
            "row-id space (max 2**31 - 1); split the store"
        )


@dataclass
class DeviceStore:
    """Normalized, row-padded embedding matrix on one device."""

    data: torch.Tensor  #: [padded_rows, dim], normalized, store dtype
    num_rows: int  #: valid rows (un-padded)
    dim: int  #: feature dim
    #: Original embedding dim when rows were Matryoshka-truncated, else None.
    matryoshka_from: Optional[int] = None

    def __post_init__(self) -> None:
        if self.data.ndim != 2 or not self.data.is_contiguous():
            raise ValueError("store data must be a contiguous [rows, dim] tensor")
        check_row_capacity(int(self.data.shape[0]))

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def padded_rows(self) -> int:
        return int(self.data.shape[0])

    @staticmethod
    def _empty(n: int, d: int, dtype, device) -> torch.Tensor:
        if n == 0:
            raise ValueError("cannot build a device store from 0 rows")
        padded = pad_to_multiple(n, ROW_ALIGN)
        check_row_capacity(padded)
        return torch.zeros((padded, d), dtype=store_dtype(dtype),
                           device=device)

    @staticmethod
    def _fill(data: torch.Tensor, start: int, rows_f32: torch.Tensor) -> None:
        """Normalize + cast ``rows_f32`` into ``data[start:]``."""
        n = rows_f32.shape[0]
        data[start:start + n] = cast_rows_to(normalize_rows(rows_f32),
                                             data.dtype)

    @staticmethod
    def from_host(
        matrix: np.ndarray,
        dtype: str = "bfloat16",
        *,
        device,
        matryoshka_dim: Optional[int] = None,
    ) -> "DeviceStore":
        """Upload a host ``[N, D]`` float32 matrix as a normalized store.

        ``matryoshka_dim``: keep only the first ``matryoshka_dim`` features
        before normalizing (nomic-embed-text-v1.5 is Matryoshka-trained);
        the engine truncates full-width queries the same way."""
        matrix = np.asarray(matrix)
        if matrix.ndim != 2:
            raise ValueError(f"expected [N, D], got {matrix.shape}")
        matryoshka_from = None
        if matryoshka_dim is not None and matryoshka_dim < matrix.shape[1]:
            matryoshka_from = matrix.shape[1]
            matrix = matrix[:, :matryoshka_dim]
        n, d = matrix.shape
        data = DeviceStore._empty(n, d, dtype, device)
        for s in range(0, n, _BUILD_ROWS):
            block = np.array(matrix[s:s + _BUILD_ROWS], dtype=np.float32,
                             order="C")
            DeviceStore._fill(data, s, torch.from_numpy(block).to(device))
        return DeviceStore(data, n, d, matryoshka_from)

    @staticmethod
    def from_parquet(
        path,
        dtype: str = "bfloat16",
        *,
        device,
        matryoshka_dim: Optional[int] = None,
    ) -> "DeviceStore":
        """Build the store from a merged Parquet file, reading and uploading
        it in row slices so the host never holds the whole matrix."""
        from .vectorstore import parquet_row_count, read_matrix_slice

        n = parquet_row_count(path)
        if n == 0:
            raise ValueError(f"store at {path} is empty")
        d_full = read_matrix_slice(path, 0, 1).shape[1]
        d = min(matryoshka_dim, d_full) if matryoshka_dim else d_full
        data = DeviceStore._empty(n, d, dtype, device)
        for s in range(0, n, _BUILD_ROWS):
            rows = read_matrix_slice(path, s, min(_BUILD_ROWS, n - s))
            block = np.array(rows[:, :d], order="C")  # writable copy
            DeviceStore._fill(data, s, torch.from_numpy(block).to(device))
        return DeviceStore(data, n, d, d_full if d < d_full else None)

    @staticmethod
    def synthetic(
        rows: int, dim: int, dtype: str = "bfloat16", seed: int = 0,
        *, device,
    ) -> "DeviceStore":
        """A random normalized store generated on ``device`` from ``seed``
        (standard normal rows) — the counterpart of the reference bench's
        ``synthetic_device_store`` (``bench/suite.py:121``). The bits differ
        from ``jax.random``'s; compare the packages through
        :meth:`from_reference` instead."""
        data = DeviceStore._empty(rows, dim, dtype, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        for s in range(0, rows, _BUILD_ROWS):
            n = min(_BUILD_ROWS, rows - s)
            x = torch.randn((n, dim), generator=gen, dtype=torch.float32,
                            device=device)
            DeviceStore._fill(data, s, x)
        return DeviceStore(data, rows, dim)

    @staticmethod
    def from_reference(
        data,
        num_rows: int,
        dim: int,
        matryoshka_from: Optional[int] = None,
        *,
        device,
    ) -> "DeviceStore":
        """The same store bits as a reference ``DeviceStore``: pass
        ``np.asarray(jax_store.data)`` (``[padded_rows, padded_dim]``, valid
        rows first, bf16 as ``ml_dtypes.bfloat16`` or f32) with its
        ``num_rows``, ``dim`` and ``matryoshka_from``. Nothing is
        re-normalized, so both packages score identical rows (for int8, the
        same lattice integers)."""
        arr = np.array(np.asarray(data)[:num_rows, :dim], order="C")
        if arr.dtype.name == "bfloat16":
            # torch.from_numpy rejects ml_dtypes arrays: move the raw bits.
            src = torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
                torch.bfloat16)
        elif arr.dtype in (np.float32, np.int8):
            src = torch.from_numpy(arr)
        else:
            raise ValueError(f"unsupported reference store dtype {arr.dtype}")
        out = DeviceStore._empty(num_rows, dim, src.dtype, device)
        out[:num_rows] = src.to(device)
        return DeviceStore(out, num_rows, dim, matryoshka_from)

    def effective_matrix(self) -> np.ndarray:
        """The valid rows as host float32, after normalization and dtype
        rounding — exactly what the engine scores against. For int8 stores
        these are the lattice integers (exact in f32), as in the reference:
        score them with :func:`..ops.quantize.int8_sims_host`, not by
        re-normalizing."""
        return self.data[: self.num_rows].to(torch.float32).cpu().numpy()
