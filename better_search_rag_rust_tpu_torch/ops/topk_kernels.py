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
K10 :func:`matmul_blockmax2x`     K1's pass on bf16/int8: unit maxima
                                  (also ``[T, R/sub]``) and, each optional,
                                  the scores ``[R, T]``, unpacked argmax and
                                  second max, the raw int8 key, coarse
                                  maxima; a runtime int8 scale
K11 :func:`gather_copy`           move each selected unit whole, keep 128
                                  values of its row 0 (bf16)
K12 :func:`gather_rescore_mm`     K2's scores plus ``copies`` copies of a
                                  resident product's block maxima (bf16)
K13 :func:`gather_cross`          each 8-query group against all of its
                                  queries' selected units, the full cross
                                  (bf16)
K17 :func:`normalize_cast`        f32 rows -> normalized rows in the store
                                  dtype, one pass (no Pallas twin); with
                                  normalization off the bf16 cast alone
--  :func:`probe_bf16_k16`        one bf16 k16 step on ``wgmma`` and on
                                  ``mma.sync`` (a measurement of the card)
=== ============================= ======================================

K10 replaces the block-max prototypes of the TPU measurement record
(``scripts/proto_*.py``); :mod:`..bench.proto_blockmax` calls it, K1, K3
and K5 under each prototype's name. K11 and K12 replace the gather
prototypes' V0 and resident-product kernels; :mod:`..bench.proto_dma`
calls them and K2. K13 replaces the fused two-level prototype's cross
scores; :mod:`..bench.proto_fused` calls it.

A wrapper takes the plain version only because its tensors lie on the CPU
(that is how the CPU tests run the whole route); for CUDA tensors it
launches the kernel or raises — there is no fallback. Each kernel launch
adds one to :data:`launch_counts`.

The CUDA kernels agree with each other bit for bit, one arithmetic rule per
dtype (see the source note): bf16 scores run on the tensor cores, one k16
product per 16 features from nothing, rows in A and queries in B, its sum
added to the score with one rounded f32 add, in increasing feature order,
in every kernel (the TPU reference's one MXU dot per score) — ``wgmma``
m64n128k16 with scale-d = 0 on TMA-fed slabs in the score tile of K1, K3,
K5, K10 and K12's product, ``mma.sync`` m16n8k16 from +0.0 in K2, K6, K12's
gather and K13, whose f32 sums the card gives bit for bit alike
(:func:`probe_bf16_k16`); f32 scores are one exact f32 FMA chain on the SIMT
pipes (TF32 would not be exact); int8 scores an exact integer dot (K1, K3,
K5 and K10 on the s8 tensor cores, ``wgmma`` fed by TMA; K2 and K6 on
``__dp4a``: an integer sum is exact in any order). The
plain versions score with one f32 matrix product (cuBLAS on the card,
without TF32), which sums in another order: on the card a plain version
agrees with its kernel to a tolerance, not bit for bit. Every bf16 kernel
score, and every plain one, lies within :func:`score_bound` of the float64
product of the same operands. The plain K2 scores the whole shard with the
same product as plain K1 and K3 and gathers, so on the CPU the three plain
versions are bitwise consistent with each other too. Plain K6 is one
batched product, whose order on the CPU need not be the matrix product's:
there it agrees with plain K3 to a tolerance. K4 moves bytes, so kernel and
plain version agree bit for bit on every dtype.

int8 stores (the lattice of :mod:`.quantize`): the kernels take the exact
int32 dot (tensor cores or ``__dp4a``) times
:data:`.quantize.INT8_INV_SCALE2`. The plain
versions form the same dot as an f32 matrix product of the lattice
integers — ``torch.matmul`` has no int32 CUDA kernel — and that is exact:
every product and partial sum is an integer of magnitude at most
``D * 127^2`` (12,386,304 at 768-d), below 2^24, so f32 holds it in any
summation order (TF32 must be off). One multiply by the same constant
follows, so plain and kernel agree bit for bit on int8.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .quantize import (
    BF16_NAN_BITS,
    BF16_NEG_NAN_BITS,
    INT8_INV_SCALE2,
    INT8_SCALE,
    store_dtype,
)

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
#: Integer pad of K10's raw int8 key: below any int8 dot at D <= 1040, and
#: ``* 128`` still in int32 range (the reference's ``_PAD_ACC``).
_PAD_ACC = -(1 << 24)
#: K10's outputs in return order, and those laid out per unit.
_K10_OUTPUTS = ("sims", "bms", "arg", "m2", "raw_key", "bm")
_K10_UNIT_OUTPUTS = ("bms", "arg", "m2", "raw_key")
#: K10's operand dtypes: the prototypes' (bf16, and int8 raw or lattice).
_K10_DTYPES = (torch.bfloat16, torch.int8)
#: Values of each selected unit's row 0 that K11 keeps (the TPU V0's
#: ``[0, :128]``).
V0_COLS = 128
#: Queries per group of K13 (the TPU kernel's ``nq``).
CROSS_GROUP = 8

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
    "matmul_blockmax2x": 0,
    "gather_copy": 0,
    "gather_rescore_mm": 0,
    "gather_cross": 0,
    "normalize_cast": 0,
    "probe_bf16_k16": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def kernel_scoring_exact_for(dtype) -> bool:
    """Whether the kernels score this store dtype with the oracle's own
    arithmetic, so that a selection over the kernels' scores is exact
    against the oracle (which scores through K3): true for bfloat16, whose
    scores are the same tensor-core instructions and rounded adds in one
    k16 order in every kernel (as the TPU's one MXU dot per score), for
    float32, one exact f32 FMA
    chain in every kernel (the TPU's Mosaic f32 product was not exact), and
    for the int8 lattice, whose scores are an exact integer dot."""
    return dtype in _DTYPE_CODES


#: Round-off per term of a bf16 kernel score: twice f32's unit round-off,
#: because the tensor cores' sum of each k16 step may truncate instead of
#: rounding to nearest.
SCORE_EPS = 2.0 ** -23


def score_bound(queries: torch.Tensor, rows: torch.Tensor):
    """``(exact, bound)``, float64: the exact scores of the operands as
    given (bf16 widens exactly) and the most a kernel's bf16 score may
    differ from them, ``D * 2^-23 * sum_d |q_d r_d|`` — the f32 round-off
    of a D-term sum (``D * 2^-24`` of the absolute terms), doubled for a
    sum that truncates (:data:`SCORE_EPS`). ``rows [R, D]`` gives ``[T,
    R]``; ``rows [T, C, D]`` (each query's own rows, e.g. gathered) gives
    ``[T, C]``. The plain versions' f32 products stay within it too (their
    sums round to nearest)."""
    q = queries.to(torch.float64)
    r = rows.to(torch.float64)
    if r.dim() == 2:
        exact, mag = q @ r.T, q.abs() @ r.abs().T
    else:
        exact = torch.einsum("td,tcd->tc", q, r)
        mag = torch.einsum("td,tcd->tc", q.abs(), r.abs())
    return exact, q.shape[-1] * SCORE_EPS * mag


def fma_rn_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``__fmaf_rn(a, b, c)``, exactly, on float64 tensors that hold f32
    values (broadcast): ``a * b`` is exact in float64 (48 bits); TwoSum
    gives ``s + e == c + a * b`` exactly; ``s + e`` rounded to odd in
    float64 (53 >= 24 + 2 bits) and then to nearest f32 is the correctly
    rounded f32 sum, ties to even, subnormals and signed zeros included.
    Returns float64 tensors holding the f32 results."""
    p = a * b
    s = c + p
    v = s - c
    e = (c - (s - v)) + (p - v)
    bits = s.view(torch.int64)
    inexact = e != 0
    # s + e lies between s and zero where e and s differ in sign: truncate s
    # one ulp toward zero, then make the last bit odd
    bits = (bits - (inexact & ((e < 0) != (s < 0))).to(torch.int64)) \
        | inexact.to(torch.int64)
    return bits.view(torch.float64).to(torch.float32).to(torch.float64)


def fma_chain_scores(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The f32 kernels' scores exactly: ``acc = +0.0``, then ``acc =
    __fmaf_rn(r_d, q_d, acc)`` for ``d = 0 .. D-1`` in order (the source
    note's f32 rule), in float64 on the operands' device, vectorised over
    the pairs and looped over D (:func:`fma_rn_f32` per step). ``rows [R,
    D]`` gives ``[T, R]``; ``rows [T, C, D]`` (each query's own rows) gives
    ``[T, C]``; float32 out. A kernel that pads a ragged D with zeros may
    return +0.0 where this returns -0.0 (the two compare equal)."""
    q = queries.to(torch.float64)
    r = rows.to(torch.float64)
    if r.dim() == 2:
        acc = torch.zeros((q.shape[0], r.shape[0]), dtype=torch.float64,
                          device=q.device)
        for d in range(q.shape[1]):
            acc = fma_rn_f32(r[None, :, d], q[:, d, None], acc)
    else:
        acc = torch.zeros(r.shape[:2], dtype=torch.float64, device=q.device)
        for d in range(q.shape[1]):
            acc = fma_rn_f32(r[:, :, d], q[:, d, None], acc)
    return acc.to(torch.float32)


# ---------------------------------------------------------------------------
# Sort keys
# ---------------------------------------------------------------------------


def m2_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 image of f32 ``x`` (-0.0 folded into +0.0):
    ``x >= y  <=>  m2_sort_key(x) >= m2_sort_key(y)``. Bitwise the
    reference's uint32 transform: ``b`` (the int32 view of ``x + 0.0``) for
    non-negative x, ``b ^ 0x7FFFFFFF`` for negative x, and ``b`` with the
    sign cleared for a NaN, so that a NaN of either sign ranks above +inf.
    The sign of a NaN score is the CPU's alone (it keeps an operand's NaN);
    the card writes every NaN score as 0x7FFFFFFF, so one rule for both signs
    gives one answer on both."""
    z = x.to(torch.float32) + 0.0
    b = z.view(torch.int32)
    return torch.where(z < 0, b ^ 0x7FFFFFFF, b & 0x7FFFFFFF)


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


def _plain_scores(queries: torch.Tensor, shard: torch.Tensor,
                  inv_scale2: float = INT8_INV_SCALE2) -> torch.Tensor:
    """``[T, R]`` f32 scores as one f32 matrix product (bf16 operands widen
    exactly; TF32 must be off, as it is by default); int8 operands: the
    exact integer dot in f32, then one multiply by ``inv_scale2``."""
    sims = queries.to(torch.float32) @ shard.to(torch.float32).T
    if shard.dtype == torch.int8:
        sims.mul_(inv_scale2)
    return sims


def _plain_masked(queries, shard, valid_rows: int,
                  inv_scale2: float = INT8_INV_SCALE2) -> torch.Tensor:
    sims = _plain_scores(queries, shard, inv_scale2)
    sims[:, max(0, valid_rows):] = PAD_SIM
    return sims


#: Scores per row chunk of the plain K1/K5/K10 (1 GiB of f32): a 10M-row
#: store at 512 queries would otherwise hold a 20 GB score matrix.
_PLAIN_SCORES = 1 << 28


def _row_chunks(t: int, r: int, align: int):
    """``(r0, r1)`` row ranges, multiples of ``align``, of at most
    :data:`_PLAIN_SCORES` scores at ``t`` queries each — one range, so
    bitwise the unchunked plain version, whenever the whole score matrix
    fits in it."""
    step = max(align, _PLAIN_SCORES // max(1, t) // align * align)
    return [(r0, min(r, r0 + step)) for r0 in range(0, r, step)]


def _plain_units(st3: torch.Tensor, with_arg: bool):
    """Unit maxima of transposed scores ``st3 [R/sub, sub, T]`` and, with
    ``with_arg``, each unit's lowest attaining row and its max with that row
    replaced by ``PAD_SIM`` (K1's and K10's unit semantics)."""
    bms = st3.amax(dim=1)
    if not with_arg:
        return bms, None, None
    sub = st3.shape[1]
    iota = torch.arange(sub, device=st3.device).view(1, sub, 1)
    eq = st3 == bms[:, None, :]
    arg = torch.where(eq, iota, sub).amin(dim=1)
    m2 = torch.where(iota == arg[:, None, :], PAD_SIM, st3).amax(dim=1)
    return bms, arg.to(torch.int32), m2


def matmul_blockmax2_only_plain(queries, shard, valid_rows, *, sub=16,
                                block=BLOCK, emit_block=False,
                                emit_argmax=False, emit_width=0):
    """Plain K1: the same outputs as :func:`matmul_blockmax2_only`, scored
    in row chunks (:func:`_row_chunks`)."""
    t = queries.shape[0]
    ew = emit_width or block
    parts = []
    for r0, r1 in _row_chunks(t, shard.shape[0], math.lcm(sub, block, ew)):
        st3 = _plain_masked(queries, shard[r0:r1], int(valid_rows) - r0).T \
            .reshape((r1 - r0) // sub, sub, t)
        bms, arg, m2 = _plain_units(st3, emit_argmax)
        outs = [bms]
        if emit_argmax:
            outs.append(pack_m2_argmax_key(m2, arg))
        if emit_block:
            outs.append(bms.reshape((r1 - r0) // ew, ew // sub, t).amax(dim=1))
        parts.append(outs)
    outs = [torch.cat(col) for col in zip(*parts)]
    return tuple(outs) if (emit_block or emit_argmax) else outs[0]


def gather_rescore_plain(queries, shard, ids, *, unit=BLOCK):
    """Plain K2: the same output as :func:`gather_rescore`, by scoring the
    shard in row chunks (:func:`_row_chunks`, so a 10M-row store never
    holds a ``[T, R]`` matrix) and gathering each selected unit's columns
    from the chunk that holds it; an id outside ``[0, R/unit)`` scores NaN,
    as in the kernel."""
    t, ks = ids.shape
    out = torch.full((t, ks, unit), float("nan"), device=queries.device)
    ids64 = ids.to(torch.int64)
    for r0, r1 in _row_chunks(t, shard.shape[0], unit):
        nu = (r1 - r0) // unit
        s3 = _plain_scores(queries, shard[r0:r1]).view(t, nu, unit)
        local = ids64 - r0 // unit
        inside = (local >= 0) & (local < nu)
        idx = local.clamp(0, nu - 1)[:, :, None].expand(t, ks, unit)
        out[inside] = torch.gather(s3, 1, idx)[inside]
    return out.reshape(t, ks * unit)


def matmul_blockmax_plain(queries, shard, valid_rows, *, block=BLOCK):
    """Plain K3: the same outputs as :func:`matmul_blockmax`."""
    t = queries.shape[0]
    r = shard.shape[0]
    sims = _plain_masked(queries, shard, int(valid_rows))
    bm_t = sims.view(t, r // block, block).amax(dim=2).T.contiguous()
    return sims, bm_t


def matmul_blockmax_only_plain(queries, shard, valid_rows, *, block=BLOCK):
    """Plain K5: plain K3's ``bm_t [R/block, T]``, scored in row chunks
    (:func:`_row_chunks`)."""
    parts = []
    for r0, r1 in _row_chunks(queries.shape[0], shard.shape[0], block):
        _, bm_t = matmul_blockmax_plain(queries, shard[r0:r1],
                                        int(valid_rows) - r0, block=block)
        parts.append(bm_t)
    return torch.cat(parts)


def matmul_blockmax2x_plain(queries, shard, valid_rows, *, sub=16,
                            emit_sims=False, t_major=False,
                            emit_arg=False, emit_m2=False,
                            emit_raw_key=False, emit_width=0,
                            inv_scale2=INT8_INV_SCALE2):
    """Plain K10: the same outputs as :func:`matmul_blockmax2x`, scored as
    plain K1 scores (:func:`_plain_masked`, :func:`_plain_units`), so on
    the CPU the two agree bit for bit on every shared output."""
    t = queries.shape[0]
    r = shard.shape[0]
    ew = emit_width
    parts = []
    for r0, r1 in _row_chunks(t, r, math.lcm(sub, ew or sub)):
        rows = shard[r0:r1]
        valid = int(valid_rows) - r0
        sims = _plain_masked(queries, rows, valid, inv_scale2)
        st3 = sims.T.reshape((r1 - r0) // sub, sub, t)
        bms, arg, m2 = _plain_units(st3, emit_arg or emit_m2)
        outs = {"sims": sims.T if emit_sims else None, "bms": bms,
                "arg": arg, "m2": m2, "raw_key": None,
                "bm": (bms.reshape((r1 - r0) // ew, ew // sub, t).amax(dim=1)
                       if ew else None)}
        if emit_raw_key:
            acc = (queries.to(torch.float32) @ rows.to(torch.float32).T) \
                .to(torch.int64)
            acc[:, max(0, valid):] = _PAD_ACC
            rev = 127 - torch.arange(sub, device=acc.device).view(1, sub, 1)
            key = acc.T.reshape((r1 - r0) // sub, sub, t) * 128 + rev
            outs["raw_key"] = key.amax(dim=1).to(torch.int32)
        parts.append(outs)
    wanted = {"sims": emit_sims, "bms": True, "arg": emit_arg,
              "m2": emit_m2, "raw_key": emit_raw_key, "bm": bool(ew)}
    result = []
    for name in _K10_OUTPUTS:
        if not wanted[name]:
            continue
        out = torch.cat([p[name] for p in parts])
        if t_major and name in _K10_UNIT_OUTPUTS:
            out = out.T.contiguous()
        result.append(out.contiguous())
    return tuple(result)


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


def gather_copy_plain(shard, ids, *, unit=BLOCK):
    """Plain K11: ``[T, KS*128]`` f32, the first :data:`V0_COLS` values of
    each selected unit's row 0 — bit for bit the store's values."""
    t, ks = ids.shape
    rows = shard[ids.long() * unit, :V0_COLS]
    return rows.float().reshape(t, ks * V0_COLS)


def gather_rescore_mm_plain(queries, shard, ids, mmq, mms, *, unit=BLOCK,
                            copies=1):
    """Plain K12: ``(mmo [tq, N/128], scores [T, KS*unit])``: plain K2's
    scores and plain K5's block maxima of ``mmq`` against ``mms``,
    transposed, computed once (every copy has the same values); ``mmo`` is
    NaN when ``copies`` is 0."""
    scores = gather_rescore_plain(queries, shard, ids, unit=unit)
    n = mms.shape[0]
    if not copies:
        return _no_product(mmq, n), scores
    mmo = matmul_blockmax_only_plain(mmq, mms, n).T.contiguous()
    return mmo, scores


def _no_product(mmq, n):
    return torch.full((mmq.shape[0], n // BLOCK), float("nan"),
                      device=mmq.device)


def gather_cross_plain(queries, shard, ids, *, unit, G):
    """Plain K13: the same ``[k/G, T, 8*G*unit]`` output as
    :func:`gather_cross`, one step ``j`` at a time: an index gather of the
    step's candidate rows for every group, then one batched f32 product
    (all steps at once would hold every gathered row in f32: 6.7 GB at 10M x
    256, unit 128). An id outside ``[0, R/unit)`` scores NaN."""
    t, k = ids.shape
    r, d = shard.shape
    nq, n_units = CROSS_GROUP, r // unit
    c = nq * G * unit
    out = torch.empty((k // G, t, c), dtype=torch.float32, device=shard.device)
    ng = t // nq
    qg = queries.to(torch.float32).view(ng, nq, d)
    offs = torch.arange(unit, device=shard.device)
    for j in range(k // G):
        # [T/8, G, 8]: candidate order (g * 8 + r) * unit + s, as the kernel's
        uid = ids[:, j * G:(j + 1) * G].long().view(ng, nq, G).transpose(1, 2)
        ok = (uid >= 0) & (uid < n_units)
        rows = (uid.clamp(0, n_units - 1)[..., None] * unit + offs)
        cand = shard[rows.reshape(ng, c)].to(torch.float32)
        s = torch.bmm(qg, cand.transpose(1, 2))
        bad = (~ok)[..., None].expand(ng, G, nq, unit).reshape(ng, 1, c)
        out[j] = s.masked_fill_(bad, float("nan")).reshape(t, c)
    return out


#: K17's norm order (``csrc/topk_kernels.cu``, THE NORM ORDER): lanes, and
#: the features of one lane's chunk step (``128 c + 4 l + j``).
NORM_LANES = 32
NORM_CHUNK = 4 * NORM_LANES


def row_sumsq_plain(x):
    """``[N]`` f32 sums of squares of ``x [N, D]`` in K17's norm order: lane
    ``l`` of 32 adds the squares of its features ``128 c + 4 l + j`` (``c``
    ascending, then ``j = 0..3``) from +0.0, one rounded multiply and one
    rounded add each; then the lane sums halve, ``v[i] += v[i + h]`` for
    ``h = 16, 8, 4, 2, 1``. Features past ``D`` are the zero pad, which
    leaves every sum as it is, so they are skipped. Plain f32 torch ops, so
    the same bits on the CPU and the card for finite rows."""
    acc = torch.zeros((x.shape[0], NORM_LANES), dtype=torch.float32,
                      device=x.device)
    for c0 in range(0, x.shape[1], NORM_CHUNK):
        for j in range(4):
            col = x[:, c0 + j:c0 + NORM_CHUNK:4]   # lane l's feature j
            acc[:, :col.shape[1]] += col * col
    h = NORM_LANES // 2
    while h:
        acc[:, :h] += acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def _cast_bf16_plain(x):
    """torch's cast (round to nearest even), then every NaN rewritten as
    :data:`.quantize.BF16_NAN_BITS` or, with the sign set,
    :data:`.quantize.BF16_NEG_NAN_BITS` — the same on every ATen CPU
    capability (torch's vectorised cast writes 0xFFFF, its scalar one
    0x7FC0, the card 0x7FFF)."""
    nan_bits = torch.where(torch.signbit(x), BF16_NEG_NAN_BITS, BF16_NAN_BITS)
    return torch.where(torch.isnan(x), nan_bits.to(torch.int16),
                       x.to(torch.bfloat16).view(torch.int16)
                       ).view(torch.bfloat16)


def _check_normalize(x, dt, normalize):
    """K17 normalizes rows ``[N, D]``; without normalization it is the bf16
    cast alone."""
    if not normalize and dt != torch.bfloat16:
        raise ValueError(f"K17 without normalization casts to bf16, not {dt}")
    if normalize and x.dim() != 2:
        raise ValueError(f"K17 normalizes rows [N, D], got {tuple(x.shape)}")


def normalize_cast_plain(x, dtype, *, normalize=True):
    """Plain K17: f32 rows ``[N, D]`` -> the store dtype. Each row divided
    by ``n = sqrt(s)`` of :func:`row_sumsq_plain` (``n == 0`` becomes 1, the
    reference's zero guard); then f32 as it is, bf16 by
    :func:`_cast_bf16_plain`, int8 on the lattice ``clip(rint(y * 127),
    -127, 127)`` with a NaN to 0. ``normalize=False`` (bf16 only): the cast
    alone, any shape."""
    dt = store_dtype(dtype)
    x = x.to(torch.float32)
    _check_normalize(x, dt, normalize)
    if not normalize:
        return _cast_bf16_plain(x)
    # sqrt_rn: the f64 root rounded to f32 is the correctly rounded f32 root
    # (53 >= 2 * 24 + 2 bits); torch's f32 sqrt on the CPU is not, on a
    # fifth of the values in torch 2.13's CPU build
    n = torch.sqrt(row_sumsq_plain(x).double()).float()[:, None]
    y = x / torch.where(n == 0.0, torch.ones_like(n), n)
    if dt == torch.bfloat16:
        return _cast_bf16_plain(y)
    if dt == torch.int8:
        r = torch.clamp(torch.round(y * INT8_SCALE), -INT8_SCALE, INT8_SCALE)
        return torch.where(torch.isnan(r), 0.0, r).to(torch.int8)
    return y


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


def _check_emit_width(kernel: str, ew: int, sub: int, block: int) -> None:
    """Coarse maxima at ``ew`` rows: a multiple of ``sub`` dividing
    ``block``, and dividing :data:`TILE_ROWS` or a multiple of it."""
    if ew <= 0 or ew % sub or block % ew or (TILE_ROWS % ew and ew % TILE_ROWS):
        raise ValueError(
            f"{kernel} emit width {ew} must be a multiple of sub {sub} "
            f"dividing block {block}, and divide {TILE_ROWS} or be a "
            f"multiple of it"
        )


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
    ``sub`` dividing ``block`` — the reference's rule without its Mosaic
    sublane clause — and dividing :data:`TILE_ROWS` or a multiple of it
    (every power-of-two width is); ``R`` a multiple of ``block`` and of
    :data:`TILE_ROWS`."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    ew = emit_width or block
    if sub not in _K1_SUBS or block % sub or r % block:
        raise ValueError(
            f"K1 geometry: sub {sub} must be one of {_K1_SUBS} dividing block"
            f" {block}, and rows {r} a multiple of block"
        )
    if emit_block:
        _check_emit_width("K1", ew, sub, block)
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


def matmul_blockmax2x(queries, shard, valid_rows, *, sub=16, emit_sims=False,
                      t_major=False, emit_arg=False,
                      emit_m2=False, emit_raw_key=False, emit_width=0,
                      inv_scale2=INT8_INV_SCALE2):
    """K10. K1's pass over bf16 or int8 ``queries [T, D]`` against ``shard
    [R, D]`` (rows at or past ``valid_rows`` score ``PAD_SIM``): the unit
    maxima and the requested optional outputs, as a tuple in this order:

    * ``sims [R, T]`` f32 (``emit_sims``): the masked scores, the
      transpose of K3's;
    * ``bms [R/sub, T]`` f32, always: unit maxima;
    * ``arg`` int32 (``emit_arg``): each unit's lowest attaining row,
      unit-local (K1's ``key & 0x7F``);
    * ``m2`` f32 (``emit_m2``): the unit's max with that row replaced by
      ``PAD_SIM`` (the second max K1 packs);
    * ``raw_key`` int32 (``emit_raw_key``, int8 only): the unit's max of
      ``acc * 128 + (127 - row)``, ``acc`` the exact integer dot and
      ``_PAD_ACC`` on masked rows;
    * ``bm [R/ew, T]`` f32 (``emit_width = ew > 0``): coarse maxima.

    ``t_major`` lays the unit outputs out ``[T, R/sub]``. int8 scores are
    the integer dot times ``inv_scale2`` (the lattice's
    :data:`.quantize.INT8_INV_SCALE2` by default). Every shared output is
    bit for bit K1's, and ``sims`` K3's scores transposed.

    Replaces the block-max prototypes ``bm2_v3`` (``scripts/proto_bm3.py``
    :176), ``bm2_b`` (``proto_bm2.py`` :111), ``bm2t_pass``
    (``proto_bmt.py`` :65), ``bm2x`` (``proto_argmax.py`` :72, modes 1 and
    2), the ``k1only`` passes of ``proto_emit_var.py`` (:167, :208) and
    ``bm2t_i8`` (``proto_int8.py`` :78). Geometry as K1's, ``ew`` checked
    against itself as ``block``."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    if sub not in _K1_SUBS:
        raise ValueError(f"K10 sub {sub} must be one of {_K1_SUBS}")
    if emit_width:
        _check_emit_width("K10", emit_width, sub, emit_width)
        if r % emit_width:
            raise ValueError(f"rows {r} must be a multiple of emit width "
                             f"{emit_width}")
    if shard.dtype not in _K10_DTYPES:
        raise TypeError(f"K10 takes bf16 or int8 operands, got {shard.dtype}")
    if emit_raw_key and shard.dtype != torch.int8:
        raise TypeError("K10 raw_key is the int8 dot's key: needs int8 "
                        f"operands, got {shard.dtype}")
    valid = max(0, min(int(valid_rows), r))
    kw = dict(sub=sub, emit_sims=emit_sims, t_major=t_major,
              emit_arg=emit_arg, emit_m2=emit_m2, emit_raw_key=emit_raw_key,
              emit_width=emit_width, inv_scale2=inv_scale2)
    if queries.device.type == "cpu":
        return matmul_blockmax2x_plain(queries, shard, valid, **kw)
    dev = queries.device
    units = (t, r // sub) if t_major else (r // sub, t)

    def out(want, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev) if want else None

    outs = {"sims": out(emit_sims, (r, t)),
            "bms": torch.empty(units, dtype=torch.float32, device=dev),
            "arg": out(emit_arg, units, torch.int32),
            "m2": out(emit_m2, units),
            "raw_key": out(emit_raw_key, units, torch.int32),
            "bm": out(bool(emit_width), (r // max(1, emit_width), t))}
    if t:
        _launch("matmul_blockmax2x", "bsr_matmul_blockmax2x", shard,
                queries.data_ptr(), shard.data_ptr(),
                _DTYPE_CODES[shard.dtype], t, r, d, valid, sub, emit_width,
                int(t_major), float(inv_scale2),
                *(_ptr(outs[name]) for name in _K10_OUTPUTS), int8_body=False)
    return tuple(outs[name] for name in _K10_OUTPUTS
                 if outs[name] is not None)


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


def _check_ids(ids, t, device):
    """int32 unit ids ``[T, KS]``, ``T`` = ``t`` unless ``t`` is None."""
    if (ids.dim() != 2 or ids.dtype != torch.int32
            or (t is not None and ids.shape[0] != t)):
        raise ValueError(f"ids must be int32 [{t or 'T'}, KS], got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if ids.device != device or not ids.is_contiguous():
        raise ValueError("ids must be contiguous, on the store's device")


def gather_copy(shard, ids, *, unit=BLOCK):
    """K11. ``[T, KS*128]`` f32: for each query's ``KS`` selected
    ``unit``-row blocks (``ids [T, KS]`` int32 unit ids into a bf16 ``shard
    [R, D]``), the first :data:`V0_COLS` values of the block's row 0, bit
    for bit the store's. The kernel moves every selected block whole into
    shared memory, so its time is the cost of moving the candidates.

    Replaces the V0 kernel of ``scripts/proto_dma2.py`` (``make_v01`` with
    ``_v0_kernel``, :72). Needs ``D >= 128`` and blocks of a multiple of 16
    bytes (``unit * D`` a multiple of 8); every id must lie in ``[0,
    R/unit)``: the kernel writes NaN for an id outside it rather than read
    out of bounds."""
    if shard.dim() != 2 or shard.dtype != torch.bfloat16:
        raise TypeError(f"K11 takes a bf16 shard [R, D], got {shard.dtype} "
                        f"{tuple(shard.shape)}")
    _check_ids(ids, None, shard.device)
    _check_device(shard, ids)
    r, d = shard.shape
    t, ks = ids.shape
    unit_bytes = unit * d * shard.element_size()
    if unit <= 0 or r % unit or d < V0_COLS or unit_bytes % 16:
        raise ValueError(f"K11: rows {r} must be a multiple of unit {unit}, "
                         f"dim {d} at least {V0_COLS} and a unit's bytes a "
                         f"multiple of 16")
    if t > 65535:
        raise ValueError(f"query tile {t} > 65535")
    if shard.device.type == "cpu":
        return gather_copy_plain(shard, ids, unit=unit)
    out = torch.empty((t, ks * V0_COLS), dtype=torch.float32,
                      device=shard.device)
    if out.numel():
        _launch("gather_copy", "bsr_gather_copy", shard, shard.data_ptr(),
                ids.data_ptr(), t, ks, r // unit, unit_bytes, out.data_ptr(),
                int8_body=False)
    return out


def gather_rescore_mm(queries, shard, ids, mmq, mms, *, unit=BLOCK,
                      copies=1):
    """K12. ``(mmo [tq, N/128], scores [T, KS*unit])`` in one launch: the
    scores of :func:`gather_rescore` (bit for bit K2's), and ``copies``
    copies of the product of ``mmq [tq, D]`` against ``mms [N, D]``, whose
    128-row block maxima go to ``mmo`` (bit for bit
    :func:`matmul_blockmax_only`'s ``bm_t`` transposed). Every copy computes
    and stores the same values: the copies are work that runs beside the
    gather. With ``copies`` 0 there is no product and ``mmo`` is NaN.

    Replaces ``make_fused`` of ``scripts/proto_dma3.py`` (:80), whose grid
    steps each recompute the product (``copies`` = its step count). bf16
    operands (the prototype's); ``N`` a positive multiple of 128."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    _check_ids(ids, t, queries.device)
    if shard.dtype != torch.bfloat16:
        raise TypeError(f"K12 takes bf16 operands, got {shard.dtype}")
    if unit <= 0 or r % unit:
        raise ValueError(f"rows {r} must be a multiple of unit {unit}")
    if mms.dim() != 2 or mms.shape[0] == 0 or mms.shape[0] % BLOCK:
        raise ValueError(f"mms must be [N, {d}] with N a positive multiple of "
                         f"{BLOCK}, got {tuple(mms.shape)}")
    _check_pair(mmq, mms)
    _check_device(queries, mmq)
    if mmq.dtype != shard.dtype or mmq.shape[1] != d:
        raise ValueError(f"mmq must be {shard.dtype} [tq, {d}], got "
                         f"{mmq.dtype} {tuple(mmq.shape)}")
    if copies < 0:
        raise ValueError(f"copies {copies} must be >= 0")
    ks, n = ids.shape[1], mms.shape[0]
    if queries.device.type == "cpu":
        return gather_rescore_mm_plain(queries, shard, ids, mmq, mms,
                                       unit=unit, copies=copies)
    dev = queries.device
    out = torch.empty((t, ks * unit), dtype=torch.float32, device=dev)
    mmo = (torch.empty((mmq.shape[0], n // BLOCK), dtype=torch.float32,
                       device=dev) if copies else _no_product(mmq, n))
    if (t and ks) or (copies and mmq.shape[0]):
        _launch("gather_rescore_mm", "bsr_gather_rescore_mm", shard,
                queries.data_ptr(), shard.data_ptr(), ids.data_ptr(), t, r, d,
                ks, unit, mmq.data_ptr(), mms.data_ptr(), mmq.shape[0], n,
                copies, out.data_ptr(), mmo.data_ptr(), int8_body=False)
    return mmo, out


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


def gather_cross(queries, shard, ids, *, unit, G):
    """K13. ``[k/G, T, 8*G*unit]`` f32: for each group of 8 consecutive
    queries and each step ``j < k/G``, the scores of all 8 queries against
    the ``8*G*unit`` rows their ``G`` selected units of the step hold
    (``ids [T, k]`` int32 unit ids into ``shard [R, D]``), in the TPU
    kernel's order::

        out[j, 8i + a, (g*8 + r)*unit + s]
            = q[8i + a] . shard[ids[8i + r, j*G + g] * unit + s]

    Keeping ``a == r`` gives :func:`gather_rescore`'s scores at ``unit``, bit
    for bit on the card (the group's 8 queries are the 8 columns of each
    ``mma.sync`` whose column 0 K2 fills); each candidate row is read once
    per group. An id outside ``[0, R/unit)`` scores NaN.

    Replaces ``fused_scores`` of ``scripts/proto_fused.py`` (:139). bf16
    operands (the prototype's); ``T % 8`` and ``k % G`` must be 0, where the
    script's grid (T/8, k/G) silently drops a tail."""
    _check_operands(queries, shard)
    t, d = queries.shape
    r = shard.shape[0]
    if shard.dtype != torch.bfloat16:
        raise TypeError(f"K13 takes bf16 operands, got {shard.dtype}")
    _check_ids(ids, t, queries.device)
    k = ids.shape[1]
    if t % CROSS_GROUP:
        raise ValueError(f"T {t} must be a multiple of {CROSS_GROUP}: the "
                         "script's grid (T/8, k/G) would drop the ragged tail")
    if G <= 0 or k % G:
        raise ValueError(f"k {k} must be a multiple of G {G}: the script's "
                         "grid (T/8, k/G) would drop the ragged tail")
    if unit <= 0 or r % unit:
        raise ValueError(f"rows {r} must be a multiple of unit {unit}")
    if k // G > 65535:
        raise ValueError(f"k/G {k // G} > 65535 steps")
    if queries.device.type == "cpu":
        return gather_cross_plain(queries, shard, ids, unit=unit, G=G)
    out = torch.empty((k // G, t, CROSS_GROUP * G * unit), dtype=torch.float32,
                      device=queries.device)
    if out.numel():
        _launch("gather_cross", "bsr_gather_cross", shard, queries.data_ptr(),
                shard.data_ptr(), ids.data_ptr(), t, r, d, k, unit, G,
                out.data_ptr(), int8_body=False)
    return out


def probe_bf16_k16_plain(rows, queries):
    """:func:`probe_bf16_k16` on any device: each k16 step's sum over its 16
    features in float64, rounded once to f32 (both outputs the same)."""
    steps = -(-rows.shape[1] // 16)
    pad = 16 * steps - rows.shape[1]
    r = torch.nn.functional.pad(rows.double(), (0, pad)).reshape(rows.shape[0], steps, 16)
    q = torch.nn.functional.pad(queries.double(), (0, pad, 0, 128 - queries.shape[0]))
    p = torch.einsum("rsf,qsf->srq", r, q.reshape(128, steps, 16)).float()
    return p, p.clone()


def probe_bf16_k16(rows, queries):
    """The instruction probe (a measurement; no TPU twin). bf16 ``rows [R,
    D]`` (R a multiple of 64) against at most 128 bf16 ``queries [T, D]``
    (zero rows fill up to 128): each 16-feature step's f32 sum of every
    (row, query) pair, ``(wg, mma)``, each ``[ceil(D / 16), R, 128]``: ``wg``
    from ``wgmma`` m64n128k16 with scale-d = 0 on the score tile's swizzled
    slabs, ``mma`` from ``mma.sync`` m16n8k16 from +0.0 (rows in A, queries
    in B, feature ``d0 + j`` in k slot ``j``). Whether they agree bit for bit
    is whether the score tile and the gathers score a pair alike. On the CPU
    :func:`probe_bf16_k16_plain`."""
    if rows.dtype != torch.bfloat16 or queries.dtype != torch.bfloat16:
        raise TypeError("the probe takes bf16 rows and queries")
    if rows.shape[0] % 64 or rows.shape[1] != queries.shape[1] or queries.shape[0] > 128:
        raise ValueError(f"probe: rows {tuple(rows.shape)} must be a multiple of 64 "
                         f"rows of the queries' width, queries {tuple(queries.shape)} "
                         f"at most 128")
    _check_device(queries, rows)
    if rows.device.type == "cpu":
        return probe_bf16_k16_plain(rows, queries)
    r, d = rows.shape
    q = torch.zeros((128, d), dtype=torch.bfloat16, device=rows.device)
    q[:queries.shape[0]] = queries
    rows = rows.contiguous()
    steps = -(-d // 16)
    wg = torch.empty((steps, r, 128), dtype=torch.float32, device=rows.device)
    mma = torch.empty_like(wg)
    _launch("probe_bf16_k16", "bsr_probe_bf16_k16", rows, rows.data_ptr(), q.data_ptr(),
            r, d, wg.data_ptr(), mma.data_ptr(), int8_body=False)
    return wg, mma


def normalize_cast(x, dtype, *, normalize=True, out=None):
    """K17. f32 rows ``x [N, D]`` -> the store dtype in one pass: each row
    L2-normalized in K17's norm order (:func:`row_sumsq_plain`, the zero
    guard), then f32 as it is, bf16 rounded to nearest even with a NaN as
    0x7FC0 by its sign (ml_dtypes' bits, the JAX package's cast; the card's
    own cast writes 0x7FFF), int8 on the lattice with a NaN to 0. Bit for
    bit :func:`normalize_cast_plain` on the same device. The one funnel of
    the store's rows (:meth:`..store.DeviceStore._fill`) and the queries'
    (:meth:`.engine.SearchEngine._cast_queries`). ``normalize=False``: the
    bf16 cast alone, any shape (:func:`.quantize.cast_rows_to`). ``out``: a
    contiguous tensor of ``x``'s shape in the store dtype to write into. No
    Pallas twin: the JAX package normalizes and casts in one XLA fusion
    (``store/device_store.py:_normalize_cast``)."""
    dt = store_dtype(dtype)
    if x.dtype != torch.float32:
        raise TypeError(f"K17 takes float32, got {x.dtype}")
    if out is not None and (out.shape != x.shape or out.dtype != dt
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous {dt} {tuple(x.shape)} on "
                         f"{x.device}")
    if x.device.type == "cpu":
        y = normalize_cast_plain(x, dt, normalize=normalize)
        return y if out is None else out.copy_(y)
    _check_normalize(x, dt, normalize)
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=dt, device=x.device) if out is None else out
    if x.numel():
        rows, d = x.shape if normalize else (x.numel(), 1)
        _launch("normalize_cast", "bsr_normalize_cast", x, x.data_ptr(),
                y.data_ptr(), rows, d, _DTYPE_CODES[dt], int(normalize),
                int8_body=False)
    return y
