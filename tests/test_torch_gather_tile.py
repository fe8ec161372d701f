"""The gather mainloop of K2 and K6 on the CPU: its copy, thread and fragment
maps emulated in numpy.

On the card ``gather_scores`` (``ops/csrc/topk_kernels.cu``) runs one query
and ``GR`` of its candidate rows per block: slabs of ``G_SB`` bytes of each
row and of the query, row-major, in a ring of ``G_STAGES`` slots of
``G_ROWS`` rows padded to ``G_PITCH`` bytes, filled by 16-byte ``cp.async``
pieces (4-byte pieces, or bytes copied by the threads, where D * itemsize
or a base forbids them), zeros past D, past C and for a unit id outside the
store. f32: thread r advances row r's chain by 16-byte fragments of the row
and the query (``fma_features``); bf16: warp w takes rows 32w .. 32w + 31 as
two m16 tiles, A fragments by ``ldmatrix`` from the slab, the query in every
column of B, one ``mma.sync`` from +0.0 per k16 step and a rounded add;
int8: thread r takes ``__dp4a`` over the slab's packs. The emulation reads
the constants out of the source, so it cannot drift from them, and checks
that every copy lands once and zero-fills, that each f32 accumulator sees d
in order (and that a crossed pair fails), that the bf16 fragments put
feature d0 + j in k slot j as the score tile's wgmma descriptors do, that the shared reads
and writes are free of bank conflicts, that the ring fits its blocks, and
that the emulated scores are :func:`fma_chain_scores` and the plain K2/K6
bit for bit. The card holds the kernels to the same
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu_torch.ops import topk_kernels as port
from better_search_rag_rust_tpu_torch.ops.quantize import quantize_unit

SOURCE = (Path(__file__).resolve().parents[1] / "better_search_rag_rust_tpu_torch"
          / "ops" / "csrc" / "topk_kernels.cu")
#: shared memory an SM holds, and what the runtime reserves per block (bytes)
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024


def constants():
    """Every ``constexpr int`` of the source whose value follows from the
    ones before it (C++ integer division)."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 SOURCE.read_text(), re.M):
        try:
            env[name] = int(eval(expr.replace("/", "//"), {}, dict(env)))
        except NameError:
            pass
    return env


C = constants()
GR, SB, PITCH, ROWS = C["G_TILE"], C["G_SB"], C["G_PITCH"], C["G_ROWS"]
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def width_of(row_bytes, bases):
    """The copy width the kernel picks (gather_scores)."""
    if row_bytes % 16 == 0 and bases % 16 == 0:
        return 16
    if row_bytes % 4 == 0 and bases % 4 == 0:
        return 4
    return 1


def copy_map(width):
    """``(thread, slab row, first byte)`` of every copy of one slab, in the
    kernel's order: thread tid takes e = tid, tid + GR, ... of the G_ROWS *
    (G_SB / width) pieces."""
    per_row = SB // width
    e = np.arange(ROWS * per_row)
    return e % GR, e // per_row, width * (e % per_row)


# -- emulated staging ------------------------------------------------------------


def stage(src, row_bytes, s, width):
    """Slab ``s`` as the copies write it: ``src [B, G_ROWS, row_bytes]``
    (int64 byte values; -1 marks a row that does not exist) gives ``slab
    [B, G_ROWS, G_PITCH]`` (-2 where nothing was written) and ``hits
    [G_ROWS, G_PITCH]``, the writes to each position."""
    _tid, r, b = copy_map(width)
    rr = np.repeat(r, width)
    bb = (b[:, None] + np.arange(width)).reshape(-1)
    piece = np.repeat(b, width)                      # a piece's first byte
    b0 = s * SB
    exists = src[:, rr, 0] >= 0
    inside = (b0 + piece < row_bytes)[None, :] & exists
    vals = src[:, rr, np.minimum(b0 + bb, row_bytes - 1)]
    slab = np.full((src.shape[0], ROWS, PITCH), -2, dtype=np.int64)
    slab[:, rr, bb] = np.where(inside, vals, 0)
    hits = np.zeros((ROWS, PITCH), dtype=int)
    np.add.at(hits, (rr, bb), 1)
    return slab, hits


def block_sources(kind, q_bytes, row_bytes_of, t_count, c, unit=None, ids=None,
                  n_units=None):
    """``src [B, G_ROWS, row_bytes]`` of every block (x, t), x-major within t:
    each candidate row's bytes (K2: store row ids[t, s / unit] * unit + s %
    unit; K6: gathered[t, s]), -1 for none, and the query at G_ROWS - 1."""
    nx = -(-c // GR)
    rb = q_bytes.shape[1]
    out = np.full((t_count * nx, ROWS, rb), -1, dtype=np.int64)
    for t in range(t_count):
        for x in range(nx):
            blk = out[t * nx + x]
            blk[GR] = q_bytes[t]
            for r in range(GR):
                s = x * GR + r
                if s >= c:
                    continue
                if kind == "k6":
                    blk[r] = row_bytes_of(t * c + s)
                else:
                    uid = ids[t, s // unit]
                    if 0 <= uid < n_units:
                        blk[r] = row_bytes_of(uid * unit + s % unit)
    return out


def as_bytes(x):
    """``[N, D]`` numpy rows (f32, bf16 bits as uint16, int8) as int64 bytes."""
    return np.ascontiguousarray(x).view(np.uint8).astype(np.int64)


def elements(slab, dtype):
    """The payload of staged slabs as float64 values of ``dtype``."""
    raw = np.ascontiguousarray(slab[..., :SB].astype(np.uint8))
    if dtype == "float32":
        return raw.view(np.float32).astype(np.float64)
    if dtype == "int8":
        return raw.view(np.int8).astype(np.float64)
    bits = raw.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


# -- the copies ----------------------------------------------------------------


CASES = [  # (D, itemsize, width): every path at a few ragged sizes
    (768, 4, 16), (100, 4, 16), (99, 4, 4), (130, 4, 4), (768, 4, 4),
    (768, 2, 16), (100, 2, 4), (130, 2, 4), (99, 2, 1), (768, 2, 1),
    (768, 1, 16), (100, 1, 4), (130, 1, 1), (99, 1, 1)]


@pytest.mark.parametrize("dim,itemsize,width", CASES)
def test_every_copy_lands_once_zero_filled(dim, itemsize, width):
    """Each slab position below G_SB is written once (the padding never),
    with byte b0 + b of its row where the piece lies inside the row and
    the row exists, and zeros past D and for a missing row; 16-byte pieces
    start 16-byte aligned and never straddle D."""
    row_bytes = dim * itemsize
    if width == 16:
        assert row_bytes % 16 == 0
    rng = np.random.default_rng(dim)
    src = rng.integers(0, 256, (2, ROWS, row_bytes))
    src[0, 5] = src[1, GR - 1] = -1                   # rows that do not exist
    for s in range(-(-row_bytes // SB)):
        slab, hits = stage(src, row_bytes, s, width)
        assert (hits[:, :SB] == 1).all() and (hits[:, SB:] == 0).all()
        gb = s * SB + np.arange(SB)
        want = np.where((gb < row_bytes)[None, None, :] & (src[:, :, :1] >= 0),
                        src[:, :, np.minimum(gb, row_bytes - 1)], 0)
        assert np.array_equal(slab[:, :, :SB], want)
    _tid, r, b = copy_map(width)
    if width == 16:
        assert ((r * PITCH + b) % 16 == 0).all()     # shared side
        assert row_bytes % 16 == 0                   # whole pieces: b0 + b < row_bytes


def test_copy_map_gives_each_thread_its_share():
    """Every thread issues G_ROWS * (G_SB / 16) / GR pieces (the query's 8
    go to threads 0-7), and consecutive threads take consecutive 16 bytes
    of one row."""
    tid, r, b = copy_map(16)
    counts = np.bincount(tid, minlength=GR)
    assert counts.max() - counts.min() == 1 and counts.sum() == ROWS * SB // 16
    assert set(tid[r == GR]) == set(range(SB // 16))
    lanes = np.arange(32)
    first = np.arange(32)                            # e = lane of warp 0
    assert np.array_equal(r[first], lanes // (SB // 16))
    assert np.array_equal(b[first], 16 * (lanes % (SB // 16)))


# -- bank conflicts --------------------------------------------------------------


def quarters_ok(addrs, width=16):
    """One phase of ``width``-byte shared accesses (8 lanes of a 16-byte
    access, a whole warp of a 4-byte one): distinct addresses fall in
    distinct banks (lanes that share an address broadcast)."""
    banks = {}
    for a in set(int(x) for x in addrs):
        for w in range(0, width, 4):
            bank = ((a + w) // 4) % 32
            if bank in banks:
                return False
            banks[bank] = a
    return True


def test_an_unpadded_pitch_would_conflict():
    """The check sees a conflict: rows of exactly G_SB bytes put 8 rows'
    pieces at one offset in the same banks."""
    assert not quarters_ok(np.arange(8) * SB)
    assert quarters_ok(np.arange(8) * PITCH)


def test_copies_and_fragment_loads_are_conflict_free():
    """The 16-byte copies' shared writes (each quarter warp of each copy
    instruction), the f32/int8 row loads (rows tid, a 16-byte piece g), the
    query's broadcast load, the bf16 B loads (4-byte words) and every
    ldmatrix (8 row addresses a matrix) are free of bank conflicts at
    every ring slot."""
    tid, r, b = copy_map(16)
    for slot in range(C["G_STAGES"]):
        base = slot * C["G_STAGE_BYTES"]
        addr = base + r * PITCH + b
        for e0 in range(0, len(addr), 8):            # instruction e0 // GR, lanes ..
            assert quarters_ok(addr[e0:e0 + 8])
        for w in range(GR // 32):
            for g in range(SB // 16):
                rows = 32 * w + np.arange(32)
                for ph in range(4):
                    assert quarters_ok(base + rows[8 * ph:8 * ph + 8] * PITCH + 16 * g)
                assert quarters_ok(np.full(8, base + GR * PITCH + 16 * g))
            lanes = np.arange(32)
            for kk in range(0, SB // 2, 16):
                qb = base + GR * PITCH + 2 * (kk + 2 * (lanes % 4))
                assert quarters_ok(qb, 4) and quarters_ok(qb + 16, 4)
                for m in range(2):
                    a = ldmatrix_addrs(w, m, kk, base)
                    for i in range(4):
                        assert quarters_ok(a[8 * i:8 * i + 8])


# -- the bf16 fragments --------------------------------------------------------


def ldmatrix_addrs(warp, m, kk, base=0):
    """Byte address each lane gives ldmatrix_x4 for m16 tile m at k step kk
    (gather_scores' a_off)."""
    lane = np.arange(32)
    a_off = (C["G_WARP_ROWS"] * warp + (lane & 15)) * PITCH + ((lane >> 4) << 4)
    return base + a_off + m * 16 * PITCH + 2 * kk


def a_fragment(addr_of_lane):
    """The m16n8k16 A tile ``[16 rows, 16 k]`` as byte addresses, from the
    32 lanes' ldmatrix row addresses: lane L's a[i] holds two elements of
    matrix i's row L / 4 (the address lane 8i + L / 4 gave), elements
    2 (L % 4) and +1; the PTX layout puts a[0] at (row g, k 2t..), a[1] at
    (g + 8, 2t..), a[2] at (g, 2t + 8..), a[3] at (g + 8, 2t + 8..)."""
    tile = np.zeros((16, 16), dtype=np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (dr, dk) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
            row_addr = addr_of_lane[8 * i + g]
            for e in range(2):
                tile[g + dr, 2 * t + dk + e] = row_addr + 2 * (2 * t + e)
    return tile


@pytest.mark.parametrize("warp", range(C["G_TILE"] // 32))
def test_bf16_k_slot_of_feature_d0_plus_j_is_score_tiles(warp):
    """A fragments from the slab hold, in k slot j of step kk, feature kk + j
    of the tile's row 32 w + 16 m + row, exactly as the score tile's wgmma
    descriptors (the swizzled slab read 32 bytes a k16 step; emulated in
    test_torch_bf16_tile.py) put feature kk + j of its rows in slot j."""
    from test_torch_bf16_tile import desc_read, tma_box

    tags = np.arange(64 * 64).reshape(64, 64)   # row r, feature f: 64 r + f
    smem = tma_box(tags, 0, 0)
    for m in range(2):
        for kk in range(0, SB // 2, 16):
            tile = a_fragment(ldmatrix_addrs(warp, m, kk))
            row, feat = np.divmod(tile, PITCH)
            assert np.array_equal(row, (C["G_WARP_ROWS"] * warp + 16 * m
                                        + np.arange(16))[:, None].repeat(16, 1))
            assert np.array_equal(feat // 2, kk + np.arange(16)[None, :].repeat(16, 0))
            st_row, st_feat = np.divmod(desc_read(smem, 32 * (kk // 16), 16), 64)
            assert np.array_equal(st_feat, feat // 2)
            assert np.array_equal(st_row, row - C["G_WARP_ROWS"] * warp - 16 * m)


def test_bf16_query_is_in_every_column_of_b():
    """b[0] and b[1] of lane (g, t) hold the query's features kk + 2t, +1
    and kk + 2t + 8, +9 whatever g: every column of B is the query."""
    lane = np.arange(32)
    for kk in range(0, SB // 2, 16):
        b0 = (2 * (kk + 2 * (lane % 4))) // 2
        b1 = (2 * (kk + 2 * (lane % 4) + 8)) // 2
        bmat = np.zeros((16, 8), dtype=int)
        for L in range(32):
            g, t = L // 4, L % 4
            bmat[2 * t, g], bmat[2 * t + 1, g] = b0[L], b0[L] + 1
            bmat[2 * t + 8, g], bmat[2 * t + 9, g] = b1[L], b1[L] + 1
        assert (bmat == (kk + np.arange(16))[:, None]).all()


# -- shared memory ---------------------------------------------------------------


def test_ring_fits_its_blocks():
    """The ring and the tile's row pointers (G_SMEM) fit G_MIN_BLOCKS blocks
    on an SM, keep (G_STAGES - 1) slabs of every block in flight, and one
    block more would not fit (the launch bound's count is what the
    occupancy gives)."""
    smem = C["G_STAGES"] * C["G_STAGE_BYTES"] + 8 * ROWS
    assert C["G_STAGE_BYTES"] == ROWS * PITCH
    assert (C["G_STAGES"] * C["G_STAGE_BYTES"]) % 8 == 0   # pointers aligned
    assert smem <= 227 * 1024
    assert C["G_MIN_BLOCKS"] * (smem + BLOCK_RESERVED) <= SM_SMEM
    assert (C["G_MIN_BLOCKS"] + 1) * (smem + BLOCK_RESERVED) > SM_SMEM
    in_flight = C["G_MIN_BLOCKS"] * (C["G_STAGES"] - 1) * GR * SB
    assert in_flight >= 128 * 1024


@pytest.mark.parametrize("c", [1, 127, 128, 129, 200, 6400])
def test_grid_scores_every_candidate_once(c):
    """Blocks (x, t) of the grid (ceil(C / G_TILE), T) write scores s0 + r
    for s0 = x * G_TILE and r < G_TILE where s0 + r < C (f32/int8: thread
    r; bf16: lane (g, 0) of warp w writes rows 32w + 16m + g + 8h): every
    candidate once, nothing past C."""
    t_count = 3
    nx = -(-c // GR)
    hits = np.zeros((t_count, c), dtype=int)
    lane = np.arange(32)
    bf16_rows = np.concatenate([
        C["G_WARP_ROWS"] * w + 16 * m + lane[lane % 4 == 0] // 4 + 8 * h
        for w in range(GR // 32) for m in range(2) for h in range(2)])
    assert np.array_equal(np.sort(bf16_rows), np.arange(GR))
    for t in range(t_count):
        for x in range(nx):
            rows = x * GR + np.arange(GR)
            np.add.at(hits[t], rows[rows < c], 1)
    assert (hits == 1).all()


# -- the arithmetic --------------------------------------------------------------


def emulate(dtype, src, row_bytes, d, width, perm=(0, 1, 2, 3), fold=None):
    """Scores ``[B, GR]`` of every block, by the kernel's loops over emulated
    slabs. ``fold(step, rows, query)`` (f32) sees each chain step's operands:
    ``rows [B, GR]``, ``query [B]``; ``perm`` is the order in which a
    fragment's 4 features are taken."""
    nb = src.shape[0]
    f = SB // ITEMSIZE[dtype]
    slabs = -(-row_bytes // SB)
    acc = torch.zeros((nb, GR), dtype=torch.float64)
    step = 0
    for s in range(slabs):
        slab, _ = stage(src, row_bytes, s, width)
        vals = elements(slab, dtype)                 # [B, G_ROWS, F]
        rows, qv = vals[:, :GR], vals[:, GR]
        if dtype == "float32":
            for g in range(SB // 16):
                for c in perm:
                    k = 4 * g + c
                    if fold is not None:
                        fold(step, rows[:, :, k], qv[:, k])
                    acc = port.fma_rn_f32(torch.from_numpy(rows[:, :, k]),
                                          torch.from_numpy(qv[:, k:k + 1]), acc)
                    step += 1
        elif dtype == "int8":
            acc += torch.from_numpy((rows * qv[:, None, :]).sum(axis=2))
        else:
            for kk in range(0, f, 16):
                if s * f + kk >= d:
                    break
                p = (rows[:, :, kk:kk + 16] * qv[:, None, kk:kk + 16]).sum(axis=2)
                acc = (acc.to(torch.float32) + torch.from_numpy(p).to(torch.float32)
                       ).to(torch.float64)
    out = acc.to(torch.float32)
    if dtype == "int8":
        out = (out * port.INT8_INV_SCALE2).to(torch.float32)
    return out.numpy(), step


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _operands(dtype, data, d, rows, t, seed):
    """Host operands ``(q, store)`` as numpy (bf16 as its uint16 bits) and
    as torch tensors."""
    rng = np.random.default_rng(seed)
    if data == "dyadic":                             # every partial sum exact
        m = np.zeros((rows + t, d), np.float32)
        for i in range(rows + t):
            cols = rng.choice(d, size=min(16, d), replace=False)
            m[i, cols] = rng.choice([-0.25, 0.25], size=cols.size)
    else:
        m = rng.standard_normal((rows + t, d)).astype(np.float32)
        m /= np.linalg.norm(m, axis=1, keepdims=True)
    x = torch.from_numpy(m)
    if dtype == "int8":
        x = quantize_unit(x)
        host = x.numpy()
    elif dtype == "bfloat16":
        x = x.to(torch.bfloat16)
        host = x.view(torch.int16).numpy().view(np.uint16)
    else:
        host = m
    return host[rows:], host[:rows], x[rows:].contiguous(), x[:rows].contiguous()


def _scores_k2(dtype, data, d, unit, ks, t=2, n_units=24, seed=0):
    qh, sh, qt, st = _operands(dtype, data, d, n_units * unit, t, seed + d + unit)
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n_units, (t, ks)), axis=1).astype(np.int32)
    ids[0, 0] = -1                                   # outside the store: NaN
    if ks > 1:
        ids[-1, -1] = n_units
    row_bytes = d * ITEMSIZE[dtype]
    src = block_sources("k2", as_bytes(qh), lambda i: as_bytes(sh[i:i + 1])[0],
                        t, ks * unit, unit=unit, ids=ids, n_units=n_units)
    width = width_of(row_bytes, 0)
    got, _ = emulate(dtype, src, row_bytes, d, width)
    c = ks * unit
    nx = -(-c // GR)
    got = got.reshape(t, nx * GR)[:, :c]
    exists = np.repeat((ids >= 0) & (ids < n_units), unit, axis=1)
    got = np.where(exists, got, np.nan).astype(np.float32)
    return got, exists, qt, st, torch.from_numpy(ids)


@pytest.mark.parametrize("d,unit,ks", [
    (768, 64, 4), (768, 8, 100), (100, 16, 100), (130, 128, 1),
    (130, 64, 4), (100, 8, 1), (768, 128, 1)])
@pytest.mark.parametrize("dtype,data", [
    ("float32", "normal"), ("float32", "dyadic"), ("bfloat16", "dyadic"),
    ("int8", "normal")])
def test_emulated_k2_is_the_kernels_rule_bit_for_bit(dtype, data, d, unit, ks):
    """The emulated K2 (ids -1 and n_units included: NaN) is, bit for bit,
    fma_chain_scores on f32, and plain K2 wherever its sums are exact
    (int8; dyadic f32 and bf16 rows)."""
    got, exists, qt, st, ids = _scores_k2(dtype, data, d, unit, ks)
    assert np.isnan(got[~exists]).all()
    plain = port.gather_rescore_plain(qt, st, ids, unit=unit).numpy()
    assert np.isnan(plain[~exists]).all()
    if dtype == "float32" and data == "normal":
        cols = torch.clamp(ids.long(), 0, st.shape[0] // unit - 1)
        rows = st.view(-1, unit, d)[cols].reshape(qt.shape[0], -1, d)
        want = port.fma_chain_scores(qt, rows).numpy()
    else:
        want = plain
    assert np.array_equal(_bits(got[exists]), _bits(want[exists]))


@pytest.mark.parametrize("dtype,data", [
    ("float32", "normal"), ("float32", "dyadic"), ("bfloat16", "dyadic"),
    ("int8", "normal")])
@pytest.mark.parametrize("d", [768, 130])
def test_emulated_k6_is_k2_and_plain_k6(dtype, data, d):
    """K6 runs K2's mainloop over gathered rows: the emulation over [T, C,
    D] (C = 200: a last block of 72 rows) gives the chain (f32) or plain K6
    (exact sums) bit for bit."""
    t, c = 2, 200
    qh, gh, qt, gt = _operands(dtype, data, d, t * c, t, seed=d)
    row_bytes = d * ITEMSIZE[dtype]
    src = block_sources("k6", as_bytes(qh), lambda i: as_bytes(gh[i:i + 1])[0],
                        t, c)
    got, _ = emulate(dtype, src, row_bytes, d, width_of(row_bytes, 0))
    got = got.reshape(t, -1)[:, :c]
    gathered = gt.view(t, c, d)
    if dtype == "float32" and data == "normal":
        want = port.fma_chain_scores(qt, gathered).numpy()
    else:
        want = port.block_scores_plain(qt, gathered).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def _order_check(d, width, perm=(0, 1, 2, 3)):
    """Whether every f32 accumulator takes feature n of its own row and of
    the query at chain step n (zeros past D), over the padded chain."""
    t, c = 1, GR
    row_bytes = 4 * d
    # each float's value names its (row, feature): row i, feature n -> i * 4096 + n
    idx = (np.arange(c + t)[:, None] * 4096 + np.arange(d)[None, :]).astype(np.float32)
    src = block_sources("k6", as_bytes(idx[c:]), lambda i: as_bytes(idx[i:i + 1])[0],
                        t, c)
    ok = []

    def fold(n, rows, query):
        if n < d:
            want_r = np.arange(GR) * 4096 + n
            want_q = c * 4096 + n
        else:
            want_r, want_q = 0, 0
        ok.append(bool(np.array_equal(rows[0], np.broadcast_to(want_r, (GR,)))
                       and query[0] == want_q))

    _, steps = emulate("float32", src, row_bytes, d, width, perm, fold)
    return steps, ok


@pytest.mark.parametrize("d,width", [(768, 16), (100, 16), (100, 4), (99, 4), (130, 4)])
def test_each_f32_accumulator_sees_d_in_order(d, width):
    """Every thread's chain takes d = 0 .. D-1 of its own row and of the
    query, in order, then exact zeros up to the slab's end (D rounded up to
    G_SB / 4 features)."""
    steps, ok = _order_check(d, width)
    assert steps == -(-4 * d // SB) * SB // 4
    assert all(ok)


@pytest.mark.parametrize("perm", [(1, 0, 2, 3), (0, 1, 3, 2)])
def test_crossed_feature_pair_fails(perm):
    """A fragment whose features are taken in a crossed order still pairs
    each row feature with its query feature, but out of order: the order
    check sees it."""
    steps, ok = _order_check(100, 16, perm)
    assert steps == 128 and not all(ok)
