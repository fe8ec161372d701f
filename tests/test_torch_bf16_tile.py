"""The bf16 score tile of K1/K3/K5/K10 (and K12's product) on the CPU: its
shared-memory and register layout in numpy.

On the card the tile runs ``wgmma.mma_async ... m64nNk16.f32.bf16.bf16``
with scale-d = 0 (``score_tile_wg`` and ``bf16_slab`` in
``ops/csrc/topk_kernels.cu``): TMA writes slabs of 128 rows x 128 bytes (64
bf16 features a row) in the 128-byte swizzle, or the producer warp stages
the same layout where TMA cannot read the operands (``stage_slab``); each
warpgroup's wgmma reads 64 store rows and N queries through shared-memory
descriptors (start address, 1024-byte stride between 8-row atoms, layout
type SWIZZLE_128B) advanced 32 bytes per k16 step; each product goes to a
product fragment and is added to the thread's 64 f32 scores with one
rounded add, step after step in increasing feature order; each thread
writes its scores to the score tile ``st``. The emulation below reads the
tile's constants out of the source, follows that layout byte for byte and
asserts that each (row, query) cell of a 128 x 128 tile collects exactly
its own products, one k16 step at a time in increasing order, and that one
crossed swizzle bit or k slot breaks it. It also emulates the ``mma.sync``
tile the wgmma tile replaced (``bench/bf16_tile_mma_sync.cuh``: ldmatrix
fragments from row-major slabs padded to SLD) and holds the two to the same
scores bit for bit on dyadic data, where every partial sum is exact; on the
card both tiles agree bit for bit on any data because the two instructions'
k16 sums do (``tests/test_torch_gpu.py``, the instruction probe).
"""

import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "better_search_rag_rust_tpu_torch" / "ops" / "csrc" / "topk_kernels.cu"
OLD_TILE = REPO / "better_search_rag_rust_tpu_torch" / "bench" / "bf16_tile_mma_sync.cuh"
#: shared memory an SM holds, and what the runtime reserves per block (bytes)
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024


def constants(*texts):
    """Every ``constexpr int`` / ``size_t`` of the texts whose value follows
    from the ones before it (C++ integer division)."""
    env = {}
    for text in texts:
        for name, expr in re.findall(r"^constexpr (?:int|size_t) (\w+) = ([^;]+);",
                                     text, re.M):
            expr = re.sub(r"sizeof\(float\)", "4", expr)
            expr = re.sub(r"\(size_t\)", "", expr)
            try:
                env[name] = int(eval(expr.replace("/", "//"), {}, dict(env)))
            except (NameError, SyntaxError):
                pass
    return env


C = constants(SOURCE.read_text())
OLD = constants(SOURCE.read_text(), OLD_TILE.read_text())
TR, TQ, SLAB = C["TR"], C["TQ"], C["SLAB_BYTES"]
F = SLAB // 2          # bf16 features of a slab row
K = 16                 # features of a k16 step (32 bytes of a descriptor)
ATOM = 1024            # one 8-row swizzle atom: the descriptors' stride
N, PROD = C["BF16_N"], C["BF16_PRODUCTS"]
NS = TQ // N           # wgmmas a k16 step


# -- the layout, emulated -------------------------------------------------------


def swizzle128(addr):
    """The 128-byte swizzle on shared-memory byte addresses (1024-byte
    aligned slabs): address bits [4:6] XOR bits [7:9]."""
    return addr ^ (((addr >> 7) & 7) << 4)


def crossed_swizzle(addr):
    """The swizzle with one bit crossed: bits [4:6] XOR bits [8:10]."""
    return addr ^ (((addr >> 8) & 7) << 4)


def tma_box(mat, r0, d0, fill=0, swz=swizzle128):
    """The slab one TMA box writes, as bf16 elements: rows [r0, r0 + 128) x
    features [d0, d0 + 64) of ``mat`` at their swizzled byte offsets / 2,
    ``fill`` past either edge."""
    n, d = mat.shape
    rows = np.arange(TR)[:, None]
    cols = np.arange(F)[None, :]
    gr, gd = r0 + rows, d0 + cols
    inside = (gr < n) & (gd < d)
    vals = np.where(inside, mat[np.minimum(gr, n - 1), np.minimum(gd, d - 1)], fill)
    out = np.full(TR * F, fill, dtype=mat.dtype)
    out[swz(rows * SLAB + 2 * cols) // 2] = vals
    return out


def staged_slab(mat, r0, d0, fill=0, threads=32):
    """The slab the producer warp stages where TMA cannot read
    (``stage_slab<__nv_bfloat16>``): lane l takes e = l, l + 32, ... of the
    128 x 8 16-byte chunks, r = e / 8, c = e % 8, and writes features d0 +
    8c .. d0 + 8c + 7 of row r0 + r (``fill`` past either edge) to bytes r *
    128 + 16 (c ^ (r % 8)) + 2b. Returns the slab and how many times each
    element was written."""
    n, d = mat.shape
    out = np.full(TR * F, fill, dtype=mat.dtype)
    hits = np.zeros(TR * F, dtype=int)
    for lane in range(threads):
        for e in range(lane, TR * 8, threads):
            r, c = e >> 3, e & 7
            gr = r0 + r
            for b in range(8):
                gd = d0 + 8 * c + b
                v = mat[gr, gd] if gr < n and gd < d else fill
                at = (r * SLAB + 16 * (c ^ (r & 7)) + 2 * b) // 2
                out[at] = v
                hits[at] += 1
    return out, hits


def desc_read(smem, start, rows, swz=swizzle128, kslot=None):
    """``[rows, 16]``: what one k16 step of a K-major SWIZZLE_128B
    descriptor at byte ``start`` hands wgmma — row m's k slot j at byte
    ``start + (m // 8) * 1024 + (m % 8) * 128 + 2 j``, through the swizzle
    (``kslot`` maps j to the slot read, for a crossed slot)."""
    m = np.arange(rows)[:, None]
    j = np.arange(K)[None, :] if kslot is None else kslot[None, :]
    return smem[swz(start + (m // 8) * ATOM + (m % 8) * SLAB + 2 * j) // 2]


def d_fragment(warp, lane, i):
    """The PTX layout of wgmma's m64nN f32 accumulator: register ``i`` of
    lane ``lane`` in warp ``warp`` (of 4) of a warpgroup holds (row,
    column)."""
    g, t = lane // 4, lane % 4
    return 16 * warp + g + 8 * ((i % 4) // 2), 8 * (i // 4) + 2 * t + i % 2


def live_steps(d, s):
    """The k16 steps of slab ``s`` the tile runs: none wholly past D."""
    return min(4, -(-(d - s * F) // K))


def emulate_tile(q, s, row0, q0, d, slab=tma_box, swz_read=swizzle128,
                 kslot=None, fill=0, step=None):
    """The two warpgroups' scores, ``[2] -> [64, 128]``, after every k16
    step of every slab in the tile's order (wgmma i of a slab: step i / NS,
    queries N (i % NS) onwards). ``step(acc, a [64, 16], b [N, 16], rows,
    cols)`` folds one wgmma's operands into the cells ``acc[rows, cols]``."""
    acc = [{}, {}]
    for sl in range(-(-d // F)):
        smem = np.concatenate([slab(s, row0, sl * F, fill),
                               slab(q, q0, sl * F, fill)])
        for wg in range(2):
            for i in range(live_steps(d, sl) * NS):
                k, chunk = divmod(i, NS)
                a = desc_read(smem, wg * 64 * SLAB + 32 * k, 64, swz_read)
                b = desc_read(smem, TR * SLAB + chunk * N * SLAB + 32 * k, N,
                              swz_read, kslot)
                step(acc[wg], a, b, slice(0, 64), slice(chunk * N, chunk * N + N))
    return acc


def epilogue_cell(warp, lane, j, h, e):
    """The kernel's write of the score tile: (st row, st column, register)
    of thread ``(warp, lane)`` (warps 0-7 of the two consumer warpgroups)
    at loop indices ``j < 16, h < 2, e < 2``."""
    g, t = lane >> 2, lane & 3
    return ((warp >> 2) * 64 + (warp & 3) * 16 + g + 8 * h,
            8 * j + 2 * t + e, 4 * j + 2 * h + e)


def _index_operands(dim, rows=256, t=200):
    """Index-tagged operands: element (r, f) of the store holds r * dim + f
    + 1, of the queries -(r * dim + f + 1); 0 is a pad."""
    s = np.arange(rows * dim, dtype=np.int64).reshape(rows, dim) + 1
    q = -(np.arange(t * dim, dtype=np.int64).reshape(t, dim) + 1)
    return q, s


def _collect(acc, a, b, rows, cols):
    """Record, per wgmma, the (row tag, query tag) pairs of every slot."""
    acc.setdefault("steps", []).append((a.copy(), b.copy(), cols.start))


def _check_own_products(steps, row0, q0, wg, dim, t):
    """Each cell (m, n) of warpgroup ``wg`` sees, over its wgmmas in order,
    the features 0 .. D-1 of store row row0 + 64 wg + m and query q0 + n in
    increasing k16 steps, the same feature in both operands' slot j, pads
    (0) only past D or past Tn."""
    per_chunk = {}
    for a, b, c0 in steps:
        per_chunk.setdefault(c0, []).append((a, b))
    assert sorted(per_chunk) == [N * c for c in range(NS)]
    for c0, seq in per_chunk.items():
        a = np.concatenate([x for x, _ in seq], axis=1)   # [64, steps * 16]
        b = np.concatenate([y for _, y in seq], axis=1)   # [N, steps * 16]
        width = K * -(-dim // K)
        assert a.shape[1] == b.shape[1] == width
        feats = np.arange(width)
        real = feats < dim
        rows = row0 + 64 * wg + np.arange(64)
        assert (a[:, real] == rows[:, None] * dim + feats[None, real] + 1).all()
        assert (a[:, ~real] == 0).all()
        qs = q0 + c0 + np.arange(N)
        qv = qs < t
        assert (b[qv][:, real] == -(qs[qv][:, None] * dim + feats[None, real] + 1)).all()
        assert (b[~qv] == 0).all() and (b[:, ~real] == 0).all()


def test_source_constants():
    """The tile the emulation follows: 128 x 128, 128-byte slab rows (64
    bf16 features), the query chunk of a wgmma dividing TQ, one or two
    product fragments, 288 threads, a 3-slab ring."""
    assert (TR, TQ, SLAB) == (128, 128, 128)
    assert TQ % N == 0 and N % 8 == 0 and PROD in (1, 2)
    assert C["NT_WG"] == C["WG_CONSUMERS"] + 32 == 288
    assert C["WG_STAGE_BYTES"] == (TR + TQ) * SLAB
    assert C["WG_LD"] % 32 == 8 and C["LDO"] % 2 == 1


@pytest.mark.parametrize("dim", [768, 100, 1040])
def test_staged_slab_is_the_tma_box(dim):
    """The producer warp's staging writes TMA's swizzled bytes, every
    element once, zero padded the same way past D and past the last row
    (here queries past Tn)."""
    q, s = _index_operands(dim, rows=200)
    for r0 in (0, 128):
        for d0 in range(0, dim, F):
            got, hits = staged_slab(s, r0, d0)
            assert (hits == 1).all()
            assert np.array_equal(got, tma_box(s, r0, d0))


@pytest.mark.parametrize("dim", [768, 100, 1040])
def test_each_cell_collects_its_own_products_in_k16_order(dim):
    """Every wgmma hands cell (m, n) of warpgroup wg, in k slot j, feature
    d0 + j of store row 64 wg + m and of query n; over the slabs and steps
    each of the D features exactly once, in increasing k16 steps; pads
    only past D and past Tn (the second query tile is ragged)."""
    q, s = _index_operands(dim)
    for row0, q0 in ((0, 0), (128, 128)):
        for slab in (tma_box, lambda m, r0, d0, fill: staged_slab(m, r0, d0, fill)[0]):
            acc = emulate_tile(q, s, row0, q0, dim, slab=slab, step=_collect)
            for wg in range(2):
                _check_own_products(acc[wg]["steps"], row0, q0, wg, dim, q.shape[0])


@pytest.mark.parametrize("dim", [768, 100])
@pytest.mark.parametrize("fault", ["crossed_swizzle", "no_swizzle", "crossed_k_slot"])
def test_one_crossed_bit_or_k_slot_fails(dim, fault):
    """Reading the slabs with one swizzle bit crossed, with none, or with
    two k slots of B swapped pairs some cell with another row's, query's or
    feature's products: the emulation sees a layout fault."""
    q, s = _index_operands(dim)
    kw = {"crossed_swizzle": dict(swz_read=crossed_swizzle),
          "no_swizzle": dict(swz_read=lambda a: a),
          "crossed_k_slot": dict(kslot=np.arange(K) ^ 1)}[fault]
    acc = emulate_tile(q, s, 0, 0, dim, step=_collect, **kw)
    with pytest.raises(AssertionError):
        for wg in range(2):
            _check_own_products(acc[wg]["steps"], 0, 0, wg, dim, q.shape[0])


@pytest.mark.parametrize("ld", ["LDO", "WG_LD"])
def test_epilogue_is_a_bijection_onto_st(ld):
    """The 256 consumer threads' 64 registers each cover every (row, query)
    cell of the 128 x 128 tile once, the cell a register is written to is
    the cell the PTX layout says it holds, and the writes land on distinct
    words of st at leading dimension LDO (K3's scalar stores) and WG_LD
    (8-byte aligned pairs)."""
    LD = C[ld]
    seen = np.zeros((TR, TQ), dtype=np.int64)
    words = set()
    for warp in range(8):
        for lane in range(32):
            regs = set()
            for j in range(16):
                for h in range(2):
                    for e in range(2):
                        r, c, i = epilogue_cell(warp, lane, j, h, e)
                        m, n = d_fragment(warp & 3, lane, i)
                        assert (r, c) == ((warp >> 2) * 64 + m, n)
                        regs.add(i)
                        seen[r, c] += 1
                        words.add(r * LD + c)
                        if LD % 2 == 0 and e == 0:
                            assert (r * LD + c) % 2 == 0   # an aligned float2
            assert regs == set(range(64))
    assert (seen == 1).all() and len(words) == TR * TQ


def test_shared_memory_fits_two_blocks():
    """K1/K10 (st at WG_LD plus the unit maxima), K3 (st at LDO) and K5: the
    ring, 1024-byte aligned behind its mbarriers, fits two blocks an SM, as
    the int8 tile's; the bf16 tile's launch bound asks for one
    (BF16_MIN_BLOCKS), since its 64 scores and two products take ~200
    registers a thread."""
    ring = C["WG_STAGES"] * C["WG_STAGE_BYTES"]
    assert ring == 96 * 1024
    for extra, ld in ((4 * C["MAX_UNITS"] * TQ, C["WG_LD"]), (0, C["LDO"]), (0, C["WG_LD"])):
        smem = C["WG_SMEM_PAD"] + max(ring, 4 * TR * max(ld, C["LDO"]) + extra)
        assert smem <= 227 * 1024
        assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM
    assert C["BF16_MIN_BLOCKS"] in (1, 2)
    assert C["WG_SMEM_PAD"] >= 1024 + 2 * 8 * C["WG_STAGES"]   # alignment slack + mbarriers


# -- values: the wgmma tile against the mma.sync tile ---------------------------


def bf16_round(x):
    """float64 -> the nearest bf16 (ties to even), as float64."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def dyadic(rng, shape):
    """bf16 values k / 64, |k| <= 32: every product is a multiple of 2^-12
    below 2^-2 and every partial sum of up to 2^12 of them exact in f32."""
    return rng.integers(-32, 33, size=shape).astype(np.float64) / 64.0


def _fold(acc, a, b, rows, cols):
    """The wgmma tile's rule: one exact k16 product (dyadic data) from
    nothing, added to each score with one rounded f32 add."""
    prod = (a @ b.T).astype(np.float32)
    cur = acc.setdefault("st", np.zeros((64, TQ), np.float32))
    cur[rows, cols] = (cur[rows, cols] + prod).astype(np.float32)


def wgmma_tile(q, s, row0, q0, d, valid):
    """``st [128, 128]`` of the emulated wgmma tile, rows at or past
    ``valid`` PAD_SIM (-3), written through the epilogue's register map."""
    acc = emulate_tile(q, s, row0, q0, d, step=_fold)
    st = np.full((TR, TQ), np.nan, np.float32)
    for warp in range(8):
        for lane in range(32):
            for j in range(16):
                for h in range(2):
                    for e in range(2):
                        r, c, i = epilogue_cell(warp, lane, j, h, e)
                        m, n = d_fragment(warp & 3, lane, i)
                        st[r, c] = acc[warp >> 2]["st"][m, n] if row0 + r < valid else -3.0
    return st


def old_slab(mat, r0, d0):
    """The mma.sync tile's slab: rows [r0, r0 + 128) x SK features,
    row-major, each row padded to SLD bf16, zeros past D and past the last
    row."""
    sk, sld = OLD["SK"], OLD["SLD"]
    n, d = mat.shape
    out = np.zeros((TR, sld))
    for r in range(TR):
        for dd in range(sk):
            if r0 + r < n and d0 + dd < d:
                out[r, dd] = mat[r0 + r, d0 + dd]
    return out.reshape(-1)


def ldmatrix(slab, addrs):
    """Four 8x8 b16 matrices: lanes 8i .. 8i + 7 give matrix i's row
    addresses (elements); lane L's register i holds matrix i's row L / 4,
    elements 2 (L % 4) and +1."""
    regs = np.zeros((32, 4, 2))
    for L in range(32):
        for i in range(4):
            base = addrs[8 * i + L // 4]
            regs[L, i] = slab[base + 2 * (L % 4):base + 2 * (L % 4) + 2]
    return regs


def mma_sync_tile(q, s, row0, q0, d, valid):
    """``st [128, 128]`` of the emulated mma.sync tile (the cuh's
    score_tile_bf16): warps WM x WN, ldmatrix fragments at a_off / b_off,
    m16n8k16 from +0.0 (exact on dyadic data) and one rounded add a score a
    k16 step, in order."""
    wm, wn, sk, sld = OLD["WM"], OLD["WN"], OLD["SK"], OLD["SLD"]
    mt, nq8 = OLD["MT"], OLD["NQ8"]
    st = np.full((TR, TQ), np.nan, np.float32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for warp in range(wm * wn):
        wr, wq = (warp // wn) * (TR // wm), (warp % wn) * (TQ // wn)
        acc = np.zeros((mt, nq8, 32, 4), np.float32)
        a_off = (wr + (lane & 15)) * sld + ((lane >> 4) << 3)
        b_off = (wq + (lane & 7) + ((lane >> 4) << 3)) * sld + (((lane >> 3) & 1) << 3)
        for sl in range(-(-d // sk)):
            rs, qs = old_slab(s, row0, sl * sk), old_slab(q, q0, sl * sk)
            for kk in range(0, sk, 16):
                if sl * sk + kk >= d:
                    break
                b = np.zeros((nq8, 32, 2, 2))
                for p in range(nq8 // 2):
                    r4 = ldmatrix(qs, b_off + p * 16 * sld + kk)
                    b[2 * p] = r4[:, [0, 1]]
                    b[2 * p + 1] = r4[:, [2, 3]]
                for i in range(mt):
                    a = ldmatrix(rs, a_off + i * 16 * sld + kk)
                    am = np.zeros((16, 16))
                    for L in range(32):
                        for r_, (dr, dk) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
                            am[g[L] + dr, 2 * t[L] + dk:2 * t[L] + dk + 2] = a[L, r_]
                    for j in range(nq8):
                        bm = np.zeros((16, 8))
                        for L in range(32):
                            bm[2 * t[L]:2 * t[L] + 2, g[L]] = b[j, L, 0]
                            bm[2 * t[L] + 8:2 * t[L] + 10, g[L]] = b[j, L, 1]
                        prod = (am @ bm).astype(np.float32)
                        for L in range(32):
                            c = [prod[g[L], 2 * t[L]], prod[g[L], 2 * t[L] + 1],
                                 prod[g[L] + 8, 2 * t[L]], prod[g[L] + 8, 2 * t[L] + 1]]
                            acc[i, j, L] = (acc[i, j, L] + np.asarray(c, np.float32)).astype(np.float32)
        for i in range(mt):
            for h in range(2):
                for L in range(32):
                    r = wr + i * 16 + g[L] + 8 * h
                    for j in range(nq8):
                        c = wq + j * 8 + 2 * t[L]
                        ok = row0 + r < valid
                        st[r, c] = acc[i, j, L, 2 * h] if ok else -3.0
                        st[r, c + 1] = acc[i, j, L, 2 * h + 1] if ok else -3.0
    return st


@pytest.mark.parametrize("dim", [100, 200])
def test_wgmma_tile_is_the_mma_sync_tile_on_dyadic_data(dim):
    """On dyadic operands every k16 sum is exact, so a k16 step's product is
    the same in either instruction: the emulated wgmma tile and the
    emulated mma.sync tile give every cell the same f32 bits, which are the
    per-step chain of the direct product (queries past Tn score 0, rows at
    or past valid_rows PAD_SIM)."""
    rng = np.random.default_rng(dim)
    rows, t, valid = 256, 200, 250
    s, q = dyadic(rng, (rows, dim)), dyadic(rng, (t, dim))
    assert np.array_equal(bf16_round(s), s) and np.array_equal(bf16_round(q), q)
    for row0, q0 in ((0, 0), (128, 128)):
        new = wgmma_tile(q, s, row0, q0, dim, valid)
        old = mma_sync_tile(q, s, row0, q0, dim, valid)
        assert np.array_equal(new.view(np.uint32), old.view(np.uint32))
        qv = q0 + np.arange(TQ) < t
        rv = row0 + np.arange(TR) < valid
        want = (s[row0:row0 + TR] @ q[q0:q0 + TQ][: qv.sum()].T).astype(np.float32)
        assert np.array_equal(new[np.ix_(rv, qv)], want[rv])
        assert (new[~rv] == -3.0).all() and (new[np.ix_(rv, ~qv)] == 0).all()
