"""The normalized embedding store on the device, in one shard or many.

Counterpart of ``better_search_rag_rust_tpu/store/device_store.py``. Rows
are L2-normalized in float32 with the zero-magnitude guard, then rounded to
the store dtype (bf16 by default, float32, or the int8 lattice of
:mod:`..ops.quantize`) — what the kernels score.

One shard (no mesh, or a mesh of one): ``data [padded_rows, dim]``,
row-major and contiguous. The JAX store pads features to the TPU's 128
lanes; that padding is gone here. Rows are padded with zero rows to a
multiple of :data:`ROW_ALIGN`, the widest row block the selection routes
tile by, so no route ever copies the store to pad it.

Sharded over a mesh's ``data`` axis (:mod:`..parallel.mesh`): the
reference's block layout. With ``S`` shards and ``N`` rows, ``chunk =
_choose_chunk(ceil(N / S), chunk_rows)`` and ``per_device_rows =
pad_to_multiple(ceil(N / S), chunk)``; shard ``s`` holds global rows ``[s *
per_device_rows, s * per_device_rows + valid_s)``, so the shards hold the
reference's blocks and a shard's row ``i`` is global row ``base + i``. Each
process holds only its own shards (``shards``, their world indices in
``shard_index``), each a ``[shard_rows, dim]`` tensor: ``per_device_rows``
padded on to a multiple of :data:`ROW_ALIGN`. Padded rows are masked to
``PAD_SIM`` inside the kernels and never displace a valid row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.quantize import store_dtype
from ..ops.topk_kernels import normalize_cast
from ..parallel.mesh import Mesh, data_axis_size, gather_objects, gather_ranks
from ..parallel.partition import pad_to_multiple

#: Row padding multiple: the rescore route's widest row block (1024 rows at
#: the low-dim geometry) and a multiple of every kernel's 128-row tile.
ROW_ALIGN = 1024
#: The reference's lane width: the smallest scan chunk of a sharded store.
LANE = 128
#: Rows normalized per step when a store is built, bounding the f32
#: intermediate (~400 MB at 768-d) next to the store.
_BUILD_ROWS = 1 << 17


def check_row_capacity(padded_rows: int) -> None:
    """Row ids travel through the selection as int32; refuse stores whose
    padded row space would overflow that rather than wrap at scale."""
    if padded_rows >= 2**31:
        raise ValueError(
            f"store has {padded_rows} padded rows, which overflows the int32 "
            "row-id space (max 2**31 - 1); shard across more devices or "
            "split the store"
        )


def _choose_chunk(per_device_target: int, chunk_rows: int) -> int:
    """The reference's scan chunk: at most ``chunk_rows``, at least one
    128-row tile; small stores collapse to a single chunk."""
    return min(chunk_rows, pad_to_multiple(per_device_target, LANE))


def shard_layout(num_rows: int, n_shards: int, chunk_rows: int = 16384
                 ) -> Tuple[int, int, int]:
    """``(per_device_rows, chunk, shard_rows)`` of ``num_rows`` rows over
    ``n_shards`` shards: the reference's blocks for several shards, and
    for one the port's single padded tensor (``per_device_rows =
    shard_rows``, one chunk)."""
    if num_rows <= 0:
        raise ValueError("cannot build a device store from 0 rows")
    if n_shards == 1:
        rows = pad_to_multiple(num_rows, ROW_ALIGN)
        return rows, rows, rows
    target = -(-num_rows // n_shards)
    chunk = _choose_chunk(target, chunk_rows)
    per_dev = pad_to_multiple(target, chunk)
    return per_dev, chunk, pad_to_multiple(per_dev, ROW_ALIGN)


@dataclass
class DeviceStore:
    """Normalized, row-padded embedding matrix: one tensor, or this
    process's shards of a mesh."""

    data: torch.Tensor  #: the first local shard (the whole store unsharded)
    num_rows: int  #: valid rows in the whole store (un-padded)
    dim: int  #: feature dim
    #: Original embedding dim when rows were Matryoshka-truncated, else None.
    matryoshka_from: Optional[int] = None
    #: The mesh the store is sharded over; None: one shard on data's device.
    mesh: Optional[Mesh] = None
    per_device_rows: int = 0  #: rows per shard's block (0: data's rows)
    chunk: int = 0  #: the reference's scan chunk (0: per_device_rows)
    shards: Tuple[torch.Tensor, ...] = ()  #: local shards (): (data,)
    shard_index: Tuple[int, ...] = ()  #: their world indices; (): (0,)

    def __post_init__(self) -> None:
        if not self.shards:
            self.shards = (self.data,)
            self.shard_index = (0,)
        self.shards = tuple(self.shards)
        self.shard_index = tuple(self.shard_index)
        if len(self.shard_index) != len(self.shards):
            raise ValueError("one world index per local shard")
        for t in self.shards:
            if t.ndim != 2 or not t.is_contiguous():
                raise ValueError(
                    "store data must be contiguous [rows, dim] tensors")
            if t.shape != self.data.shape or t.dtype != self.data.dtype:
                raise ValueError("every shard must have data's shape and dtype")
        if self.mesh is not None:
            _check_data_mesh(self.mesh)
        self.per_device_rows = self.per_device_rows or int(self.data.shape[0])
        self.chunk = self.chunk or self.per_device_rows
        if self.per_device_rows > self.data.shape[0]:
            raise ValueError("per_device_rows exceeds the shard tensors")
        check_row_capacity(self.padded_rows)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def n_shards(self) -> int:
        """Shards in the whole world (the mesh's data axis)."""
        return 1 if self.mesh is None else data_axis_size(self.mesh)

    @property
    def padded_rows(self) -> int:
        """Padded row space of the whole store (``per_device_rows`` per
        shard): the global row ids live below it."""
        return self.per_device_rows * self.n_shards

    @property
    def shard_rows(self) -> int:
        """Rows of each shard tensor (``per_device_rows`` padded on to
        :data:`ROW_ALIGN`)."""
        return int(self.data.shape[0])

    @property
    def multi_process(self) -> bool:
        """Whether other processes hold shards of this store."""
        return self.mesh is not None and self.mesh.world_size > 1

    def shard_base(self, s: int) -> int:
        """Global row id of world shard ``s``'s first row."""
        return s * self.per_device_rows

    def shard_valid(self, s: int) -> int:
        """Valid rows in world shard ``s`` (0 for an empty trailing shard)."""
        return max(0, min(self.per_device_rows,
                          self.num_rows - self.shard_base(s)))

    def local(self) -> List[Tuple[int, torch.Tensor, int, int]]:
        """``(world index, tensor, base, valid rows)`` of each local shard."""
        return [(s, t, self.shard_base(s), self.shard_valid(s))
                for s, t in zip(self.shard_index, self.shards)]

    # -- construction -------------------------------------------------------

    @staticmethod
    def _empty(n: int, d: int, dtype, device) -> torch.Tensor:
        rows, _chunk, _rows = shard_layout(n, 1)
        check_row_capacity(rows)
        return torch.zeros((rows, d), dtype=store_dtype(dtype), device=device)

    @staticmethod
    def _fill(data: torch.Tensor, start: int, rows_f32: torch.Tensor) -> None:
        """Normalize + cast ``rows_f32`` into ``data[start:]``: one K17
        launch on the card, written in place."""
        n = rows_f32.shape[0]
        normalize_cast(rows_f32.to(torch.float32), data.dtype,
                       out=data[start:start + n])

    @staticmethod
    def _build(n: int, d: int, dtype, device, mesh: Optional[Mesh],
               chunk_rows: int, read: Callable[[int, int], torch.Tensor],
               normalize: bool, matryoshka_from: Optional[int]
               ) -> "DeviceStore":
        """Allocate this process's shards of an ``n x d`` store and fill
        each from ``read(start, count)`` (global rows, a CPU tensor) in
        blocks of :data:`_BUILD_ROWS`: normalized and cast, or copied as
        they are (``normalize=False``)."""
        if mesh is None:
            if device is None:
                raise ValueError("pass device= or mesh=")
            n_shards, local = 1, [(0, torch.device(device))]
        else:
            _check_data_mesh(mesh)
            n_shards = data_axis_size(mesh)
            local = [(i, s.device) for i, s in mesh.local_shards()]
        per_dev, chunk, rows = shard_layout(n, n_shards, chunk_rows)
        check_row_capacity(per_dev * n_shards)
        sdt = store_dtype(dtype)
        shards = []
        for s, dev in local:
            t = torch.zeros((rows, d), dtype=sdt, device=dev)
            base = s * per_dev
            valid = max(0, min(per_dev, n - base))
            for off in range(0, valid, _BUILD_ROWS):
                block = read(base + off, min(_BUILD_ROWS, valid - off)).to(dev)
                if normalize:
                    DeviceStore._fill(t, off, block)
                else:
                    t[off:off + block.shape[0]] = block
            shards.append(t)
        return DeviceStore(shards[0], n, d, matryoshka_from,
                           mesh if n_shards > 1 else None, per_dev, chunk,
                           tuple(shards), tuple(s for s, _dev in local))

    @staticmethod
    def from_host(
        matrix: np.ndarray,
        dtype: str = "bfloat16",
        *,
        device=None,
        mesh: Optional[Mesh] = None,
        matryoshka_dim: Optional[int] = None,
        chunk_rows: int = 16384,
    ) -> "DeviceStore":
        """Upload a host ``[N, D]`` float32 matrix as a normalized store, on
        ``device`` or sharded over ``mesh`` (this process's shards only).

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

        def read(start, count):
            return torch.from_numpy(np.array(
                matrix[start:start + count], dtype=np.float32, order="C"))

        return DeviceStore._build(n, d, dtype, device, mesh, chunk_rows, read,
                                  True, matryoshka_from)

    @staticmethod
    def from_parquet(
        path,
        dtype: str = "bfloat16",
        *,
        device=None,
        mesh: Optional[Mesh] = None,
        matryoshka_dim: Optional[int] = None,
        chunk_rows: int = 16384,
    ) -> "DeviceStore":
        """Build the store from a merged Parquet file, on ``device`` or over
        ``mesh``: each process reads only the row blocks of its own shards,
        in slices (:func:`..vectorstore.read_matrix_slice`), so no host ever
        holds the whole matrix."""
        from .vectorstore import parquet_row_count, read_matrix_slice

        n = parquet_row_count(path)
        if n == 0:
            raise ValueError(f"store at {path} is empty")
        d_full = read_matrix_slice(path, 0, 1).shape[1]
        d = min(matryoshka_dim, d_full) if matryoshka_dim else d_full

        def read(start, count):
            rows = read_matrix_slice(path, start, count)
            return torch.from_numpy(np.array(rows[:, :d], order="C"))

        return DeviceStore._build(n, d, dtype, device, mesh, chunk_rows, read,
                                  True, d_full if d < d_full else None)

    @staticmethod
    def from_parquet_sharded(
        path,
        mesh: Mesh,
        dtype: str = "bfloat16",
        chunk_rows: int = 16384,
        matryoshka_dim: Optional[int] = None,
    ) -> "DeviceStore":
        """The reference's name (``store/device_store.py:144``) for
        :meth:`from_parquet` over ``mesh``."""
        return DeviceStore.from_parquet(path, dtype, mesh=mesh,
                                        matryoshka_dim=matryoshka_dim,
                                        chunk_rows=chunk_rows)

    @staticmethod
    def synthetic(
        rows: int, dim: int, dtype: str = "bfloat16", seed: int = 0,
        *, device,
    ) -> "DeviceStore":
        """A random normalized store generated on ``device`` from ``seed``
        (standard normal rows) — the counterpart of the reference bench's
        ``synthetic_device_store`` (``bench/suite.py:121``). The bits differ
        from ``jax.random``'s; compare the packages through
        :meth:`from_reference` instead. :meth:`reshard` lays it out over a
        mesh."""
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
        device=None,
        mesh: Optional[Mesh] = None,
        chunk_rows: int = 16384,
    ) -> "DeviceStore":
        """The same store bits as a reference ``DeviceStore``: pass
        ``np.asarray(jax_store.data)`` (``[padded_rows, padded_dim]``, valid
        rows first, bf16 as ``ml_dtypes.bfloat16`` or f32) with its
        ``num_rows``, ``dim`` and ``matryoshka_from``, and a ``device`` or a
        ``mesh`` (with the reference store's ``chunk_rows``, the shards
        hold its blocks). Nothing is re-normalized, so both packages score
        identical rows (for int8, the same lattice integers)."""
        arr = np.asarray(data)[:num_rows, :dim]
        if arr.dtype.name == "bfloat16":
            tdt = torch.bfloat16
        elif arr.dtype in (np.float32, np.int8):
            tdt = torch.from_numpy(np.zeros(0, arr.dtype)).dtype
        else:
            raise ValueError(f"unsupported reference store dtype {arr.dtype}")

        def read(start, count):
            block = np.array(arr[start:start + count], order="C")
            if tdt == torch.bfloat16:
                # torch.from_numpy rejects ml_dtypes arrays: move the bits
                return torch.from_numpy(
                    block.view(np.uint16).view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(block)

        return DeviceStore._build(num_rows, dim, tdt, device, mesh, chunk_rows,
                                  read, False, matryoshka_from)

    def reshard(self, mesh: Optional[Mesh] = None, *, device=None,
                chunk_rows: int = 16384) -> "DeviceStore":
        """The same rows (bit for bit, nothing re-normalized) laid out over
        ``mesh``, or in one shard on ``device``. Single-process stores."""
        if self.multi_process:
            raise ValueError("reshard reads every row: one process only")

        def read(start, count):
            return self._local_rows(start, count)

        return DeviceStore._build(self.num_rows, self.dim, self.dtype, device,
                                  mesh, chunk_rows, read, False,
                                  self.matryoshka_from)

    # -- access -------------------------------------------------------------

    def _local_rows(self, start: int, count: int) -> torch.Tensor:
        """Global rows ``[start, start + count)`` from the local shards (on
        the first shard's device)."""
        parts = []
        for _s, t, base, valid in self.local():
            lo, hi = max(start, base), min(start + count, base + valid)
            if lo < hi:
                parts.append(t[lo - base:hi - base].to(self.device))
        out = torch.cat(parts) if len(parts) > 1 else parts[0]
        if out.shape[0] != count:
            raise IndexError(f"rows [{start}, {start + count}) are not local")
        return out

    def take_rows(self, ids: np.ndarray) -> torch.Tensor:
        """Rows at global ``ids`` (``[len(ids), dim]``, store dtype, on
        :attr:`device`). Across processes this is a collective: every rank
        passes the same ids and gets every row."""
        ids = np.asarray(ids, dtype=np.int64)
        out = torch.zeros((ids.size, self.dim), dtype=self.dtype,
                          device=self.device)
        owner = torch.zeros(ids.size, dtype=torch.bool, device=self.device)
        for _s, t, base, valid in self.local():
            mine = np.nonzero((ids >= base) & (ids < base + valid))[0]
            if mine.size:
                idx = torch.from_numpy(mine).to(self.device)
                local = torch.from_numpy(ids[mine] - base).to(t.device)
                out[idx] = t[local].to(self.device)
                owner[idx] = True
        if self.multi_process:
            rows, owners = gather_ranks(out), gather_ranks(owner)
            if not bool((owners.sum(dim=0) == 1).all()):
                raise IndexError("every id must be a row of exactly one rank")
            return rows[owners.to(torch.int64).argmax(dim=0),
                        torch.arange(ids.size, device=self.device)]
        if not bool(owner.all()):
            raise IndexError(f"ids outside [0, {self.num_rows})")
        return out

    def effective_matrix(self) -> np.ndarray:
        """The valid rows as host float32, after normalization and dtype
        rounding — exactly what the engine scores against. For int8 stores
        these are the lattice integers (exact in f32), as in the reference:
        score them with :func:`..ops.quantize.int8_sims_host`, not by
        re-normalizing. Across processes this is a collective."""
        mine = [t[:valid].to(torch.float32).cpu().numpy()
                for _s, t, _base, valid in self.local()]
        if self.multi_process:
            mine = [m for rank in gather_objects(mine) for m in rank]
        return np.concatenate(mine) if len(mine) > 1 else mine[0]


def _check_data_mesh(mesh: Mesh) -> None:
    """The store shards over the ``data`` axis only."""
    if "data" not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no 'data' axis")
    others = {a: n for a, n in mesh.shape.items() if a != "data" and n != 1}
    if others:
        raise ValueError(
            f"the store shards over the 'data' axis only; mesh axes {others} "
            "would replicate it")
