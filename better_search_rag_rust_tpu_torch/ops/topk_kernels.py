"""Scoring kernels of the exact search path: wrappers and plain versions.

Counterpart of ``better_search_rag_rust_tpu/ops/topk_pallas.py``. Each of
the Pallas kernels on the search routes has a hand-written CUDA kernel
(``csrc/topk_kernels.cu``) and, in this module, a wrapper and a plain
PyTorch version of the same function:

=== ============================= ======================================
K1  :func:`matmul_blockmax2_only` sub-unit maxima (+ packed second-max /
                                  argmax key, + coarse maxima), no scores
K2  :func:`gather_rescore`        rescore each query's own selected units
K3  :func:`matmul_blockmax`       masked scores + per-block maxima
K4  :func:`gather_rows`           copy each query's selected units' rows
K5  :func:`matmul_blockmax_only`  K3's per-block maxima alone, no scores
K6  :func:`block_scores`          score each query's own gathered rows
=== ============================= ======================================

A wrapper takes the plain version only because its tensors lie on the CPU
(that is how the CPU tests run the whole route); for CUDA tensors it
launches the kernel or raises — there is no fallback. Each kernel launch
adds one to :data:`launch_counts`.

Where the CUDA kernels agree bit for bit (one f32 FMA chain per score,
see the source note), the plain versions score with one f32 matrix product
(cuBLAS on the card, without TF32), which sums in another order: on the card
a plain version agrees with its kernel to a tolerance, not bit for bit. The
plain K2 scores the whole shard with the same product as plain K1 and K3
and gathers, so on the CPU the three plain versions are bitwise consistent
with each other too. Plain K6 is one batched product, whose order on the CPU
need not be the matrix product's: there it agrees with plain K3 to a
tolerance. K4 moves bytes, so kernel and plain version agree bit for bit on
every dtype.

int8 stores (the lattice of :mod:`.quantize`): the kernels take the exact
int32 dot (``__dp4a``) times :data:`.quantize.INT8_INV_SCALE2`. The plain
versions form the same dot as an f32 matrix product of the lattice
integers — ``torch.matmul`` has no int32 CUDA kernel — and that is exact:
every product and partial sum is an integer of magnitude at most
``D * 127^2`` (12,386,304 at 768-d), below 2^24, so f32 holds it in any
summation order (TF32 must be off). One multiply by the same constant
follows, so plain and kernel agree bit for bit on int8.
"""

from __future__ import annotations

from typing import Dict

import torch

from .quantize import INT8_INV_SCALE2

#: Default row-block width for block maxima.
BLOCK = 128
#: Sentinel similarity for padded store rows; every valid cosine is >= -1.
PAD_SIM = -3.0
#: Rows per thread-block tile of K1/K3 (``TR`` in the CUDA source): a shard's
#: row count must be a multiple of it, and sub / block / emit widths divide it.
TILE_ROWS = 128
INT32_MAX = 2**31 - 1

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_K1_SUBS = (8, 16, 32, 64, 128)
#: Widest int8 dim whose dot stays exact in f32 (D * 127^2 <= 2^24).
INT8_MAX_DIM = 1040

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`;
#: the int8 bodies count under ``<wrapper>_int8``.
launch_counts: Dict[str, int] = {
    "matmul_blockmax2_only": 0,
    "gather_rescore": 0,
    "matmul_blockmax": 0,
    "matmul_blockmax_only": 0,
    "matmul_blockmax2_only_int8": 0,
    "gather_rescore_int8": 0,
    "matmul_blockmax_int8": 0,
    "gather_rows": 0,
    "block_scores": 0,
    "block_scores_int8": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def kernel_scoring_exact_for(dtype) -> bool:
    """Whether the kernels score this store dtype with the oracle's own
    arithmetic: true for float32 and bfloat16, whose scores are one exact
    f32 FMA chain in every kernel (the TPU's Mosaic f32 product was not),
    and for the int8 lattice, whose scores are an exact integer dot."""
    return dtype in _DTYPE_CODES


# ---------------------------------------------------------------------------
# Sort keys
# ---------------------------------------------------------------------------


def m2_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 image of f32 ``x`` (-0.0 folded into +0.0):
    ``x >= y  <=>  m2_sort_key(x) >= m2_sort_key(y)``. Bitwise the
    reference's uint32 transform: ``b`` (the int32 view of ``x + 0.0``) for
    non-negative x, ``b ^ 0x7FFFFFFF`` for negative x."""
    z = x.to(torch.float32) + 0.0
    b = z.view(torch.int32)
    return torch.where(z < 0, b ^ 0x7FFFFFFF, b)


def pack_m2_argmax_key(m2: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """A unit's second max and sub-local argmax packed into ONE int32 key:
    m2's monotone uint image rounded UP to a multiple of 128 in the high 25
    bits, ``arg`` (< 128) in the low 7 — bitwise the reference's
    ``pack_m2_argmax_key``. Conservative (``key >= m2_sort_key(m2)``),
    tight (``< m2_sort_key(m2) + 2**8``), ``key & 0x7F == arg``. The uint32
    arithmetic runs in int64 and narrows at the end."""
    mono = m2_sort_key(m2).to(torch.int64) + 2**31
    key = ((mono + 0x7F) & 0xFFFFFF80) | arg.to(torch.int64)
    return (key - 2**31).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _plain_scores(queries: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """``[T, R]`` f32 scores as one f32 matrix product (bf16 operands widen
    exactly; TF32 must be off, as it is by default); int8 operands: the
    exact integer dot in f32, then one multiply by ``INT8_INV_SCALE2``."""
    sims = queries.to(torch.float32) @ shard.to(torch.float32).T
    if shard.dtype == torch.int8:
        sims.mul_(INT8_INV_SCALE2)
    return sims


def _plain_masked(queries, shard, valid_rows: int) -> torch.Tensor:
    sims = _plain_scores(queries, shard)
    sims[:, max(0, valid_rows):] = PAD_SIM
    return sims


def matmul_blockmax2_only_plain(queries, shard, valid_rows, *, sub=16,
                                block=BLOCK, emit_block=False,
                                emit_argmax=False, emit_width=0):
    """Plain K1: the same outputs as :func:`matmul_blockmax2_only`."""
    t = queries.shape[0]
    r = shard.shape[0]
    st = _plain_masked(queries, shard, int(valid_rows)).T.reshape(
        r // sub, sub, t)
    bms = st.amax(dim=1)
    outs = [bms]
    if emit_argmax:
        iota = torch.arange(sub, device=st.device).view(1, sub, 1)
        eq = st == bms[:, None, :]
        arg = torch.where(eq, iota, sub).amin(dim=1)
        m2 = torch.where(iota == arg[:, None, :], PAD_SIM, st).amax(dim=1)
        outs.append(pack_m2_argmax_key(m2, arg))
    if emit_block:
        ew = emit_width or block
        outs.append(bms.reshape(r // ew, ew // sub, t).amax(dim=1))
    return tuple(outs) if (emit_block or emit_argmax) else outs[0]


def gather_rescore_plain(queries, shard, ids, *, unit=BLOCK):
    """Plain K2: the same output as :func:`gather_rescore`, by scoring the
    whole shard and gathering the selected units' columns."""
    t, ks = ids.shape
    r = shard.shape[0]
    s3 = _plain_scores(queries, shard).view(t, r // unit, unit)
    idx = ids.to(torch.int64)[:, :, None].expand(t, ks, unit)
    return torch.gather(s3, 1, idx).reshape(t, ks * unit)


def matmul_blockmax_plain(queries, shard, valid_rows, *, block=BLOCK):
    """Plain K3: the same outputs as :func:`matmul_blockmax`."""
    t = queries.shape[0]
    r = shard.shape[0]
    sims = _plain_masked(queries, shard, int(valid_rows))
    bm_t = sims.view(t, r // block, block).amax(dim=2).T.contiguous()
    return sims, bm_t


#: Scores per row chunk of plain K5 (1 GiB of f32): a 10M-row store at 512
#: queries would otherwise hold a 20 GB score matrix.
_PLAIN_BM_ONLY_SCORES = 1 << 28


def matmul_blockmax_only_plain(queries, shard, valid_rows, *, block=BLOCK):
    """Plain K5: plain K3's ``bm_t [R/block, T]``, scored in row chunks of
    at most :data:`_PLAIN_BM_ONLY_SCORES` scores (one chunk, so bitwise plain
    K3's, whenever the whole score matrix fits in it)."""
    t = max(1, queries.shape[0])
    r = shard.shape[0]
    step = max(block, _PLAIN_BM_ONLY_SCORES // t // block * block)
    parts = []
    for r0 in range(0, r, step):
        chunk = shard[r0:r0 + step]
        _, bm_t = matmul_blockmax_plain(queries, chunk, int(valid_rows) - r0,
                                        block=block)
        parts.append(bm_t)
    return torch.cat(parts)


def gather_rows_plain(shard, ids, *, unit=8):
    """Plain K4: ``shard.view(R/unit, unit, D)[ids]`` as ``[T, KS*unit,
    D]``; a unit id outside ``[0, R/unit)`` gives 0xFF bytes, as the
    kernel writes."""
    r, d = shard.shape
    t, ks = ids.shape
    ok = (ids >= 0) & (ids < r // unit)
    out = shard.view(r // unit, unit, d)[torch.where(ok, ids, 0).long()]
    out.view(torch.uint8)[~ok] = 0xFF
    return out.reshape(t, ks * unit, d)


def block_scores_plain(queries, gathered):
    """Plain K6: ``[T, C]`` f32 scores of each query against its own rows,
    one batched f32 product (TF32 off); int8: the exact integer dot in f32,
    then one multiply by ``INT8_INV_SCALE2``."""
    sims = torch.bmm(gathered.to(torch.float32),
                     queries.to(torch.float32)[:, :, None])[:, :, 0]
    if gathered.dtype == torch.int8:
        sims.mul_(INT8_INV_SCALE2)
    return sims


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_pair(queries: torch.Tensor, rows: torch.Tensor) -> None:
    """Queries ``[T, D]`` and the rows they score (``[..., D]``): one
    scoring dtype, one device, contiguous."""
    if queries.dim() != 2 or queries.shape[1] != rows.shape[-1]:
        raise ValueError(f"need queries [T, {rows.shape[-1]}], got "
                         f"{tuple(queries.shape)}")
    if queries.dtype != rows.dtype or queries.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"queries and rows must share a dtype in float32/bfloat16/int8, "
            f"got {queries.dtype} and {rows.dtype}"
        )
    if rows.dtype == torch.int8 and rows.shape[-1] > INT8_MAX_DIM:
        raise ValueError(f"int8 dim {rows.shape[-1]} > {INT8_MAX_DIM}: the "
                         "dot would leave f32's exact integer range")
    _check_device(queries, rows)
    if queries.shape[0] > 65535:
        raise ValueError(f"query tile {queries.shape[0]} > 65535")


def _check_device(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"device mismatch {a.device} vs {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("operands must be contiguous")


def _check_operands(queries: torch.Tensor, shard: torch.Tensor) -> None:
    if shard.dim() != 2:
        raise ValueError(f"need shard [R, D], got {tuple(shard.shape)}")
    _check_pair(queries, shard)
    r = shard.shape[0]
    if r == 0 or r % TILE_ROWS:
        raise ValueError(f"shard rows {r} must be a positive multiple of "
                         f"{TILE_ROWS}")


def _launch(name: str, fn_name: str, shard: torch.Tensor, *args,
            int8_body: bool = True) -> None:
    """Call a C entry point on the shard's device and current stream; raise
    on its returned CUDA error; count the launch (int8 bodies apart)."""
    from ._build import library

    if int8_body and shard.dtype == torch.int8:
        name += "_int8"
    lib = library()
    with torch.cuda.device(shard.device):
        stream = torch.cuda.current_stream(shard.device).cuda_stream
        err = getattr(lib.lib, fn_name)(*args, stream)
    lib.check(name, err)
    launch_counts[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def matmul_blockmax2_only(queries, shard, valid_rows, *, sub=16, block=BLOCK,
                          emit_block=False, emit_argmax=False, emit_width=0):
    """K1. Sub-unit maxima ``bm_sub [R/sub, T]`` f32 of ``queries [T, D]``
    against ``shard [R, D]`` without writing the scores; rows at or past
    ``valid_rows`` score ``PAD_SIM``. With ``emit_argmax`` also ``key
    [R/sub, T]`` int32: each unit's argmax row (lowest attaining,
    unit-local) and second max (max with that row left out) packed by
    :func:`pack_m2_argmax_key`. With ``emit_block`` also the coarse maxima
    ``bm [R/ew, T]`` at ``ew = emit_width or block``. Output order
    ``(bm_sub, [key,] [bm])``; a lone ``bm_sub`` is returned bare.

    Replaces ``topk_pallas.matmul_blockmax2_only`` (:527). Geometry: ``sub``
    in (8, 16, 32, 64, 128) dividing ``block``; ``ew`` a multiple of
    ``sub`` dividing ``block`` and :data:`TILE_ROWS`; ``R`` a multiple of
    ``block`` and of :data:`TILE_ROWS`."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    ew = emit_width or block
    if sub not in _K1_SUBS or block % sub or r % block:
        raise ValueError(
            f"K1 geometry: sub {sub} must be one of {_K1_SUBS} dividing block"
            f" {block}, and rows {r} a multiple of block"
        )
    if emit_block and (ew % sub or block % ew or TILE_ROWS % ew):
        raise ValueError(
            f"K1 emit width {ew} must be a multiple of sub {sub} dividing "
            f"block {block} and {TILE_ROWS}"
        )
    valid = max(0, min(int(valid_rows), r))
    if queries.device.type == "cpu":
        return matmul_blockmax2_only_plain(
            queries, shard, valid, sub=sub, block=block, emit_block=emit_block,
            emit_argmax=emit_argmax, emit_width=emit_width)
    dev = queries.device
    bm_sub = torch.empty((r // sub, t), dtype=torch.float32, device=dev)
    key = (torch.empty((r // sub, t), dtype=torch.int32, device=dev)
           if emit_argmax else None)
    bm = (torch.empty((r // ew, t), dtype=torch.float32, device=dev)
          if emit_block else None)
    if t:
        _launch("matmul_blockmax2_only", "bsr_matmul_blockmax2", shard,
                queries.data_ptr(), shard.data_ptr(),
                _DTYPE_CODES[shard.dtype], t, r, d, valid, sub, ew,
                bm_sub.data_ptr(), _ptr(key), _ptr(bm))
    outs = tuple(o for o in (bm_sub, key, bm) if o is not None)
    return outs if len(outs) > 1 else bm_sub


def gather_rescore(queries, shard, ids, *, unit=BLOCK):
    """K2. ``scores [T, KS*unit]`` f32 of each query against its own ``KS``
    selected ``unit``-row store blocks (``ids [T, KS]`` int32 unit ids into
    ``shard [R, D]``), bitwise the scores K1 and K3 give the same pairs.

    Replaces ``topk_pallas.gather_rescore`` (:656); the TPU's ``cpg`` DMA
    grouping has no counterpart here. Every id must lie in ``[0, R/unit)``;
    the kernel scores an id outside it as NaN rather than read out of
    bounds."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    if ids.dim() != 2 or ids.shape[0] != t or ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 [{t}, KS], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if ids.device != queries.device or not ids.is_contiguous():
        raise ValueError("ids must be contiguous, on the queries' device")
    if unit <= 0 or r % unit:
        raise ValueError(f"rows {r} must be a multiple of unit {unit}")
    ks = ids.shape[1]
    if queries.device.type == "cpu":
        return gather_rescore_plain(queries, shard, ids, unit=unit)
    out = torch.empty((t, ks * unit), dtype=torch.float32,
                      device=queries.device)
    if t and ks:
        _launch("gather_rescore", "bsr_gather_rescore", shard,
                queries.data_ptr(), shard.data_ptr(), ids.data_ptr(),
                _DTYPE_CODES[shard.dtype], t, r, d, ks, unit, out.data_ptr())
    return out


def matmul_blockmax(queries, shard, valid_rows, *, block=BLOCK):
    """K3. ``(sims [T, R] f32, bm_t [R/block, T] f32)``: masked scores of
    ``queries [T, D]`` against ``shard [R, D]`` (rows at or past
    ``valid_rows`` score ``PAD_SIM``) and their per-``block`` maxima.

    Replaces ``topk_pallas.matmul_blockmax`` (:120). ``block`` must divide
    :data:`TILE_ROWS`."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    if block <= 0 or TILE_ROWS % block:
        raise ValueError(f"K3 block {block} must divide {TILE_ROWS}")
    valid = max(0, min(int(valid_rows), r))
    if queries.device.type == "cpu":
        return matmul_blockmax_plain(queries, shard, valid, block=block)
    dev = queries.device
    sims = torch.empty((t, r), dtype=torch.float32, device=dev)
    bm_t = torch.empty((r // block, t), dtype=torch.float32, device=dev)
    if t:
        _launch("matmul_blockmax", "bsr_matmul_blockmax", shard,
                queries.data_ptr(), shard.data_ptr(),
                _DTYPE_CODES[shard.dtype], t, r, d, valid, block,
                sims.data_ptr(), bm_t.data_ptr())
    return sims, bm_t


def matmul_blockmax_only(queries, shard, valid_rows, *, block=BLOCK):
    """K5. ``bm_t [R/block, T]`` f32: the per-``block`` maxima of the scores
    of ``queries [T, D]`` against ``shard [R, D]``, rows at or past
    ``valid_rows`` scoring ``PAD_SIM``, without writing the scores — bit for
    bit :func:`matmul_blockmax`'s ``bm_t`` on every dtype.

    Replaces ``topk_pallas.matmul_blockmax_only`` (:222); its Mosaic row
    tile (``pick_bm_row_tile``) is the TPU's. ``block`` must divide
    :data:`TILE_ROWS`, and ``R`` be a multiple of it."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    if block <= 0 or TILE_ROWS % block:
        raise ValueError(f"K5 block {block} must divide {TILE_ROWS}")
    valid = max(0, min(int(valid_rows), r))
    if queries.device.type == "cpu":
        return matmul_blockmax_only_plain(queries, shard, valid, block=block)
    bm_t = torch.empty((r // block, t), dtype=torch.float32,
                       device=queries.device)
    if t:
        _launch("matmul_blockmax_only", "bsr_matmul_blockmax_only", shard,
                queries.data_ptr(), shard.data_ptr(),
                _DTYPE_CODES[shard.dtype], t, r, d, valid, block,
                bm_t.data_ptr(), int8_body=False)
    return bm_t


def gather_rows(shard, ids, *, unit=8):
    """K4. ``rows [T, KS*unit, D]`` in the shard's dtype: each query's
    ``KS`` selected ``unit``-row store blocks (``ids [T, KS]`` int32 unit
    ids into ``shard [R, D]``), bit for bit the store rows whatever the
    dtype. An id outside ``[0, R/unit)`` gives rows of 0xFF bytes (NaN on
    float stores), never a read past the store.

    Replaces ``topk_pallas.gather_rows`` (:747); its ``T % 8``, ``KS %
    cpg`` and sublane rules are the TPU's and are not carried over."""
    if shard.dim() != 2 or ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"need shard [R, D] and int32 ids [T, KS], got "
                         f"{tuple(shard.shape)} and {ids.dtype} "
                         f"{tuple(ids.shape)}")
    _check_device(shard, ids)
    r, d = shard.shape
    t, ks = ids.shape
    if unit <= 0 or r % unit:
        raise ValueError(f"rows {r} must be a multiple of unit {unit}")
    if t > 65535:
        raise ValueError(f"query tile {t} > 65535")
    if shard.device.type == "cpu":
        return gather_rows_plain(shard, ids, unit=unit)
    out = torch.empty((t, ks * unit, d), dtype=shard.dtype,
                      device=shard.device)
    if out.numel():
        _launch("gather_rows", "bsr_gather_rows", shard, shard.data_ptr(),
                ids.data_ptr(), t, ks, r // unit,
                unit * d * shard.element_size(), out.data_ptr(),
                int8_body=False)
    return out


def block_scores(queries, gathered):
    """K6. ``[T, C]`` f32 scores of each query of ``queries [T, D]`` against
    ITS OWN ``C`` rows of ``gathered [T, C, D]`` (e.g. from
    :func:`gather_rows`), bit for bit the scores K1, K2 and K3 give the
    same (query, row) pairs: the kernel stages and sums exactly as K2.

    Replaces ``topk_pallas.block_scores`` (:846); no ``T % 8`` rule and no
    candidate tile (``_pick_score_ctile``): both are the TPU's."""
    if gathered.dim() != 3 or gathered.shape[0] != queries.shape[0]:
        raise ValueError(f"need gathered [T, C, D] with T = "
                         f"{queries.shape[0]}, got {tuple(gathered.shape)}")
    _check_pair(queries, gathered)
    t, c, d = gathered.shape
    if queries.device.type == "cpu":
        return block_scores_plain(queries, gathered)
    out = torch.empty((t, c), dtype=torch.float32, device=queries.device)
    if t and c:
        _launch("block_scores", "bsr_block_scores", gathered,
                queries.data_ptr(), gathered.data_ptr(),
                _DTYPE_CODES[gathered.dtype], t, c, d, out.data_ptr())
    return out
