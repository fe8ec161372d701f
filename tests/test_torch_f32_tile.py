"""The f32 score tile of K1/K3/K5/K10 on the CPU: the exact chain reference
against rational arithmetic, and the tile's maps emulated in numpy.

On the card ``score_tile<float>`` (``ops/csrc/topk_kernels.cu``) stages
slabs of ``F32_SK`` features of 128 store rows and 128 queries, row-major
as they lie in device memory, into a ring of ``F32_STAGES`` slabs with
``cp.async`` (16-byte pieces, or 4-byte elements where D % 4 != 0 or a base
is not 16-byte aligned), zero-filled past D and past Tn; each thread reads
its rows' and queries' next 4 features as 16-byte shared loads and advances
its MR x MQ accumulators over them in order (``fma_features``). The emulation
below reads the tile's constants out of the source, so it cannot drift from
them, and asserts that every copy lands once, that the threads' micro-tiles
cover the 128 x 128 tile once, that each accumulator sees feature d of its
own row and query at chain step d (zeros past D up to the padded length),
that each warp's fragment loads are free of bank conflicts, and that one
crossed feature pair inside a fragment breaks the order. The card holds the
kernels to :func:`fma_chain_scores` bit for bit (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here that reference is held to exact ``Fraction``
arithmetic, correctly rounded to f32.
"""

import re
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu_torch.bench import ab_topk
from better_search_rag_rust_tpu_torch.ops import _build
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port

SOURCE = (Path(__file__).resolve().parents[1] / "better_search_rag_rust_tpu_torch"
          / "ops" / "csrc" / "topk_kernels.cu")
DIMS = [768, 100, 99, 4, 1040]
#: (D, staging path): the 16-byte path only where D % 4 == 0 (the kernel's
#: condition; an unaligned base takes the 4-byte path at any D)
PATHS = [(d, vec) for d in DIMS for vec in (True, False) if not (vec and d % 4)]
#: shared memory an SM holds, and what the runtime reserves per block (bytes)
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024


def tile_constants():
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


C = tile_constants()


# -- the exact chain against rational arithmetic ------------------------------


def round_f32(x: Fraction, negative_zero: bool = False) -> float:
    """``x`` rounded to the nearest f32, ties to even (subnormals
    included); an exact zero is -0.0 only when ``negative_zero``."""
    if x == 0:
        return -0.0 if negative_zero else 0.0
    neg, m = x < 0, abs(x)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    if Fraction(2) ** e > m:
        e -= 1                              # 2^e <= m < 2^(e+1)
    q = max(e - 23, -149)                   # the ulp's exponent
    v = float(round(m / Fraction(2) ** q) * Fraction(2) ** q)
    v = v if v < 2.0 ** 128 else float("inf")
    return -v if neg else v


def exact_fma(a: float, b: float, c: float) -> float:
    """IEEE fmaf: ``a * b + c`` rounded once; an exact zero is -0.0 only
    when the zero product and ``c`` are both -0.0."""
    x = Fraction(a) * Fraction(b) + Fraction(c)
    minus = (a == 0 or b == 0) and c == 0 and (
        (np.signbit(a) != np.signbit(b)) and np.signbit(c))
    return round_f32(x, negative_zero=bool(minus))


def f32(x) -> float:
    return float(np.float32(x))


def bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _random_f32(rng, n, lo=-60, hi=60):
    """f32 values with random signs, mantissas and exponents 2^lo .. 2^hi."""
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exp = (rng.integers(lo, hi, n) + 127).astype(np.uint32) << 23
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    return (sign | exp | mant).view(np.float32)


def _triples():
    """Random triples (c independent, c near -a*b, c = -fl(a*b)), crafted
    halfway cases, cancellations to +-0, and subnormal results."""
    rng = np.random.default_rng(0)
    a, b = _random_f32(rng, 300), _random_f32(rng, 300)
    ab = (a.astype(np.float64) * b).astype(np.float32)
    wiggle = 1 + rng.integers(-4, 5, 300) * 2.0 ** -23
    cases = list(zip(a[:100], b[:100], _random_f32(rng, 100)))
    cases += list(zip(a[100:200], b[100:200],
                      (-ab[100:200] * wiggle[100:200]).astype(np.float32)))
    cases += list(zip(a[200:], b[200:], -ab[200:]))  # the FMA's error term
    p12, p23 = 2.0 ** -12, 2.0 ** -23
    cases += [
        (p12, p12, 1.0),                          # 1 + 2^-24: tie, to even 1
        (p12, p12, 1 + p23),                      # tie, to even 1 + 2^-22
        (p12 * (1 + p23), p12, 1.0),              # just above the tie: up
        (2.0 ** -13, p12, 1.0),                   # below the tie: 1
        # 2^-70 below a tie: float64 alone would round onto the tie and then
        # to even (double rounding); fmaf rounds down to 1 + 2^-23
        ((1 - p23) * p12, (1 + p23) * p12, 1 + p23),
        (-(1 - p23) * p12, (1 + p23) * p12, -1 - p23),
        (-p12, p12, 1.0),                         # 1 - 2^-24: exact
        (3.0, 1 / 3, -1.0),                       # fl(3 * fl(1/3)) - 1 != 0
        (1.5, 2.0, -3.0),                         # exact cancellation: +0
        (-1.5, 2.0, 3.0),                         # +0
        (0.0, 2.0, 0.0), (-0.0, 2.0, 0.0),        # +0
        (1.5 * 2.0 ** -75, 2.0 ** -74, 0.0),      # 1.5 * 2^-149: tie, to 2^-148
        (1.25 * 2.0 ** -75, 2.0 ** -74, 0.0),     # 2^-149
        (2.0 ** -80, 2.0 ** -80, 0.0),            # underflow to +0
        (-(2.0 ** -80), 2.0 ** -80, 0.0),         # underflow to -0
        (2.0 ** -70, 2.0 ** -70, 2.0 ** -140),    # subnormal sum
        (2.0 ** -63, 2.0 ** -63, -(2.0 ** -126)),  # normal minus subnormal
        (2.0 ** -63, 2.0 ** -64, 2.0 ** -149),    # subnormal plus min
    ]
    signed_zeros = [(-0.0, 2.0, -0.0), (0.0, -2.0, -0.0), (0.0, 2.0, -0.0),
                    (-0.0, -0.0, -0.0), (-0.0, 0.0, 0.0)]
    return [tuple(f32(v) for v in t) for t in cases], signed_zeros


def test_fma_rn_f32_is_the_correctly_rounded_fma():
    """The float64 step (product, TwoSum, round to odd, round to f32) is
    exact fmaf bit for bit, signed zeros included."""
    cases, signed_zeros = _triples()
    cases += signed_zeros
    a, b, c = (torch.tensor([t[i] for t in cases], dtype=torch.float64)
               for i in range(3))
    got = port.fma_rn_f32(a, b, c).to(torch.float32).numpy()
    want = np.array([exact_fma(*t) for t in cases], dtype=np.float32)
    bad = np.flatnonzero(bits(got) != bits(want))
    assert not bad.size, [(cases[i], got[i], want[i]) for i in bad[:5]]


def test_chain_single_fmas_match_fractions():
    """Through the public chain: queries ``[1, a]`` against rows ``[c,
    b]`` give ``fma(b, a, fma(c, 1, +0))`` = ``fma(a, b, c)`` (for c not
    -0.0, which ``fma(c, 1, +0)`` turns into +0.0), as ``[T, C, D]`` and
    as ``[R, D]``."""
    cases, _ = _triples()
    a, b, c = (np.array([t[i] for t in cases], dtype=np.float32)
               for i in range(3))
    queries = torch.from_numpy(np.stack([np.ones_like(a), a], axis=1))
    rows = torch.from_numpy(np.stack([c, b], axis=1))
    want = np.array([exact_fma(*t) for t in cases], dtype=np.float32)
    got = port.fma_chain_scores(queries, rows[:, None, :]).numpy()[:, 0]
    assert np.array_equal(bits(got), bits(want))
    cross = port.fma_chain_scores(queries, rows).numpy()
    assert np.array_equal(bits(np.diag(cross)), bits(want))


def test_chain_matches_a_fraction_chain():
    """Several steps: the float64 chain equals the chain of correctly
    rounded fmaf steps, in both output forms."""
    rng = np.random.default_rng(1)
    t, r, d = 3, 5, 9
    q = rng.standard_normal((t, d)).astype(np.float32)
    rows = rng.standard_normal((r, d)).astype(np.float32)
    rows[2] = -q[1] * 0.75                      # heavy cancellation
    want = np.zeros((t, r), dtype=np.float32)
    for i in range(t):
        for j in range(r):
            acc = 0.0
            for k in range(d):
                acc = exact_fma(float(rows[j, k]), float(q[i, k]), acc)
            want[i, j] = acc
    got = port.fma_chain_scores(torch.from_numpy(q), torch.from_numpy(rows))
    assert np.array_equal(bits(got.numpy()), bits(want))
    gathered = np.broadcast_to(rows, (t, r, d)).copy()
    got3 = port.fma_chain_scores(torch.from_numpy(q), torch.from_numpy(gathered))
    assert np.array_equal(bits(got3.numpy()), bits(want))


def test_chain_within_the_bound_of_the_reference_scores():
    """The chain and the JAX reference's f32 scores (interpret-mode K3) both
    lie within :func:`score_bound` of the float64 product."""
    rng = np.random.default_rng(2)
    m = rng.standard_normal((256, 100)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = m[rng.integers(0, 256, 16)]
    chain = port.fma_chain_scores(torch.from_numpy(q), torch.from_numpy(m))
    sims, _ = ref.matmul_blockmax(jnp.asarray(q), jnp.asarray(m), jnp.int32(256),
                                  interpret=True)
    exact, bound = port.score_bound(torch.from_numpy(q), torch.from_numpy(m))
    assert ((chain.double() - exact).abs() <= bound).all()
    ref_sims = torch.from_numpy(np.array(sims)).double()
    assert ((ref_sims - exact).abs() <= bound).all()


# -- the tile's maps, emulated -------------------------------------------------


def thread_map():
    """``(rows [F32_NT, MR], queries [F32_NT, MQ])``: the tile rows and query
    columns of each thread's accumulators, in the kernel's (i, j) order
    (j = F32_QG * h + jj)."""
    tid = np.arange(C["F32_NT"])
    warp, lane = tid // 32, tid % 32
    rb = (warp // C["F32_WQ"]) * C["F32_ROWS_W"] + lane // C["F32_LQ"]
    qb = (warp % C["F32_WQ"]) * C["F32_QUERIES_W"] + lane % C["F32_LQ"]
    rows = rb[:, None] + C["F32_RSTEP"] * np.arange(C["MR"])[None, :]
    queries = qb[:, None] + C["F32_LQ"] * np.arange(C["MQ"])[None, :]
    return rows, queries


def stage_slab(idx, base, n, d0, vec, fill=-1):
    """The slab a stage() call writes for one operand: ``[TR, F32_SLD]``
    of ``idx[base + r, d0 + dd]`` (an index or a value), ``fill`` for the
    zero-filled copies (past D, past ``n`` rows), NaN where nothing was
    written; and how often each position was written. ``vec``: the 16-byte
    path (pieces of 4), else 4-byte elements."""
    tr, sk, sld = C["TR"], C["F32_SK"], C["F32_SLD"]
    d = idx.shape[1]
    slab = np.full((tr, sld), np.nan)
    hits = np.zeros((tr, sld), dtype=int)
    width = 4 if vec else 1
    per_row = sk // width
    for e in range(tr * per_row):           # every thread's e = tid + k * F32_NT
        r, dd = e // per_row, width * (e % per_row)
        gd, g = d0 + dd, base + r
        full = gd < d and g < n
        for b in range(width):
            slab[r, dd + b] = idx[g, gd + b] if full else fill
            hits[r, dd + b] += 1
    return slab, hits


def _index_operands(dim, rows=256, t=200):
    s_idx = np.arange(rows * dim, dtype=np.int64).reshape(rows, dim)
    q_idx = np.arange(t * dim, dtype=np.int64).reshape(t, dim)
    return q_idx, s_idx


def emulate_chain(q, s, row0, q0, vec, fold, perm=(0, 1, 2, 3), fill=-1):
    """Run the tile's loops over emulated slabs: for every chain step, the
    ``[NT, MR]`` row operands and ``[NT, MQ]`` query operands each thread's
    accumulators take (``perm``: the order in which a fragment's 4 features
    are taken). ``fold(step, r_ops, q_ops)`` sees each step; returns the
    number of steps. Zero-filled copies read as ``fill``."""
    d, tn = s.shape[1], q.shape[0]
    sk, pad = C["F32_SK"], C["F32_PAD"]
    dpad = -(-d // pad) * pad
    rows, queries = thread_map()
    step = 0
    for sl in range(-(-d // sk)):
        rs, _ = stage_slab(s, row0, s.shape[0], sl * sk, vec, fill)
        qs, _ = stage_slab(q, q0, tn, sl * sk, vec, fill)
        for k in range(0, sk, 4):
            if sl * sk + k >= dpad:
                break
            rv = rs[rows, k:k + 4]          # [NT, MR, 4]: 16-byte loads
            qv = qs[queries, k:k + 4]       # [NT, MQ, 4]
            for c in perm:
                fold(step, rv[:, :, c], qv[:, :, c])
                step += 1
    return step


def test_thread_map_covers_the_tile_once():
    """The threads' MR x MQ accumulators cover each of the 128 x 128
    (row, query) cells once, and each warp's cells form its warp tile."""
    rows, queries = thread_map()
    seen = np.zeros((C["TR"], C["TQ"]), dtype=int)
    np.add.at(seen, (rows[:, :, None], queries[:, None, :]), 1)
    assert (seen == 1).all()
    for w in range(C["F32_NT"] // 32):
        r, q = rows[32 * w:32 * w + 32], queries[32 * w:32 * w + 32]
        assert np.ptp(r) == C["F32_ROWS_W"] - 1 and np.ptp(q) == C["F32_QUERIES_W"] - 1


@pytest.mark.parametrize("dim,vec", PATHS)
def test_every_copy_lands_once_zero_filled(dim, vec):
    """Both staging paths write each slab position below F32_SK once (the
    padding columns never), features past D and queries past Tn as zeros,
    at 16-byte aligned pieces on the 16-byte path."""
    assert C["F32_SLD"] % 4 == 0 and C["F32_SLAB"] % 4 == 0
    q_idx, s_idx = _index_operands(dim)
    sk = C["F32_SK"]
    for base, n, idx in ((128, 256, s_idx), (128, 200, q_idx)):  # 72 queries
        for d0 in range(0, dim, sk):
            slab, hits = stage_slab(idx, base, n, d0, vec)
            assert (hits[:, :sk] == 1).all() and (hits[:, sk:] == 0).all()
            g = base + np.arange(C["TR"])[:, None]
            gd = d0 + np.arange(sk)[None, :]
            inside = (g < n) & (gd < dim)
            want = np.where(inside, idx[np.minimum(g, n - 1), np.minimum(gd, dim - 1)], -1)
            assert np.array_equal(slab[:, :sk], want)


def _order_check(dim, vec, perm=(0, 1, 2, 3)):
    """Whether every accumulator takes feature t of its own row and query
    at chain step t (zeros past D), over the padded chain."""
    q_idx, s_idx = _index_operands(dim)
    rows, queries = thread_map()
    ok = []

    def fold(t, r_ops, q_ops):
        if t < dim:
            want_r = (128 + rows) * dim + t          # row tile 1
            qg = 128 + queries                       # query tile 1: 72 valid
            want_q = np.where(qg < q_idx.shape[0], qg * dim + t, -1)
        else:
            want_r, want_q = -1, -1
        ok.append(bool(np.array_equal(r_ops, np.broadcast_to(want_r, r_ops.shape))
                       and np.array_equal(q_ops, np.broadcast_to(want_q, q_ops.shape))))

    steps = emulate_chain(q_idx, s_idx, 128, 128, vec, fold, perm)
    return steps, ok


@pytest.mark.parametrize("dim,vec", PATHS)
def test_each_accumulator_sees_d_in_order(dim, vec):
    """Every accumulator of every thread takes d = 0 .. D-1 of its own row
    and query, in order, then exact zeros up to D rounded up to F32_PAD."""
    steps, ok = _order_check(dim, vec)
    assert steps == -(-dim // C["F32_PAD"]) * C["F32_PAD"]
    assert all(ok)


@pytest.mark.parametrize("perm", [(1, 0, 2, 3), (0, 1, 3, 2)])
def test_crossed_feature_pair_fails(perm):
    """A fragment whose features are taken in a crossed order pairs each
    row feature with its query feature still, but out of order: the order
    check sees it."""
    steps, ok = _order_check(100, True, perm)
    assert steps == 112 and not all(ok)


def _load_banks_ok(addr_words):
    """One warp's 16-byte shared loads at these word addresses: every bank
    serves one distinct word (distinct chunks in distinct banks; lanes that
    share a chunk broadcast) — one wavefront."""
    assert (addr_words % 4 == 0).all()              # 16-byte aligned
    words = {a + b for a in set(addr_words.tolist()) for b in range(4)}
    banks = [w % 32 for w in words]
    return len(banks) == len(set(banks)) and len(words) <= 32


def test_fragment_loads_are_conflict_free():
    """Each warp's 8 row loads and 8 query loads per fragment, at every
    feature offset of the slab and every ring slot, are free of bank
    conflicts (4 distinct rows, 8 distinct queries a load)."""
    rows, queries = thread_map()
    sld, slab = C["F32_SLD"], C["F32_SLAB"]
    for stage in range(C["F32_STAGES"]):
        base = stage * 2 * slab
        for k in range(0, C["F32_SK"], 4):
            for w in range(C["F32_NT"] // 32):
                lanes = slice(32 * w, 32 * w + 32)
                for i in range(C["MR"]):
                    a = base + rows[lanes, i] * sld + k
                    assert _load_banks_ok(a)
                    assert len(set(a.tolist())) == 32 // C["F32_LQ"]
                for j in range(C["MQ"]):
                    a = base + slab + queries[lanes, j] * sld + k
                    assert _load_banks_ok(a)
                    assert len(set(a.tolist())) == C["F32_LQ"]


def test_an_unpadded_slab_would_conflict():
    """The check sees a conflict: rows of F32_SK floats (no padding) put
    every query of a load in the same banks."""
    _, queries = thread_map()
    a = queries[:32, 0] * C["F32_SK"]
    assert not _load_banks_ok(a)


def test_shared_memory_fits_the_blocks():
    """The ring, and K1's score tile plus unit maxima (written after the
    ring drains), fit F32_MIN_BLOCKS blocks on an SM."""
    ring = 4 * C["F32_STAGES"] * 2 * C["F32_SLAB"]
    past_st = 4 * C["TR"] * C["LDO"] + 4 * C["MAX_UNITS"] * C["TQ"]
    block = max(ring, past_st)
    assert block <= 227 * 1024
    assert C["F32_MIN_BLOCKS"] * (block + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("dim", [100, 40])
def test_emulated_tile_is_the_chain_bit_for_bit(dim, vec):
    """Values: folding the emulated operands with the f32 FMA step gives
    :func:`fma_chain_scores` of the tile's rows and queries bit for bit
    (queries past Tn score +0)."""
    rng = np.random.default_rng(dim)
    s = rng.standard_normal((256, dim)).astype(np.float32)
    q = rng.standard_normal((200, dim)).astype(np.float32)
    rows, queries = thread_map()
    acc = torch.zeros((C["F32_NT"], C["MR"], C["MQ"]), dtype=torch.float64)

    def fold(t, r_ops, q_ops):
        nonlocal acc
        acc = port.fma_rn_f32(torch.from_numpy(r_ops)[:, :, None],
                              torch.from_numpy(q_ops)[:, None, :], acc)

    emulate_chain(q.astype(np.float64), s.astype(np.float64), 128, 128, vec,
                  fold, fill=0.0)
    st = np.full((C["TR"], C["TQ"]), np.nan, dtype=np.float32)
    st[rows[:, :, None], queries[:, None, :]] = acc.to(torch.float32).numpy()
    want = port.fma_chain_scores(torch.from_numpy(q[128:]),
                                 torch.from_numpy(s[128:])).numpy().T
    assert np.array_equal(bits(st[:, :72]), bits(want))
    assert (st[:, 72:] == 0).all()


# -- bench/ab_topk.py on the CPU ------------------------------------------------


@pytest.mark.parametrize("name", sorted(ab_topk.VARIANTS))
def test_ab_topk_variants_edit_the_tree_source(name):
    """Each variant's edit still applies to the tree's source (an edit that
    no longer matches would time the tree under the variant's name) and
    keeps every entry point the package binds."""
    src = ab_topk.TREE_SOURCE.read_text()
    out = ab_topk.VARIANTS[name](src)
    assert out != src
    for entry in _build.SOURCES["topk"][1]:
        assert f"{entry}(" in out
