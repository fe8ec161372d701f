"""The bf16 score bound of the search kernels on the CPU.

On the card every bf16 score is one tensor-core instruction per 16 features
(``ops/csrc/topk_kernels.cu``), whose f32 sum may truncate; each score is
held to ``ops.topk_kernels.score_bound``: within ``D * 2^-23 * sum_d |q_d
r_d|`` of the float64 product of the same bf16 operands. The card checks
(``tests/test_torch_gpu.py``, ``chip_smoke.py``) hold the kernels to it; here
the plain versions — f32 products that round to nearest, the scores the CPU
routes run on — are held to the same bound on seeded bf16 rows, and a wrong
fragment layout (features paired across the halves of a k16 step) is shown
to break it.
"""

import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

DIMS = [768, 100, 64]  # the search width, a ragged k16 step, one below 128
ROWS, T, UNIT = 1024, 24, 16


def _operands(dim, seed=0):
    rng = np.random.default_rng(seed + dim)
    m = rng.standard_normal((ROWS, dim)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    mat = torch.from_numpy(m).to(torch.bfloat16)
    q = mat[torch.from_numpy(rng.integers(0, ROWS, T))].contiguous()
    ids = torch.from_numpy(rng.integers(0, ROWS // UNIT, (T, 6))).to(torch.int32)
    return q, mat, ids


def _unit_rows(mat, ids):
    """``[T, KS*UNIT, D]``: each query's selected units' rows, slot order."""
    rows = ids.long()[:, :, None] * UNIT + torch.arange(UNIT)
    return mat[rows.reshape(ids.shape[0], -1)]


def _within(scores, exact, bound):
    return bool(((scores.to(torch.float64) - exact).abs() <= bound).all())


@pytest.mark.parametrize("dim", DIMS)
def test_plain_k3_scores_within_bound(dim):
    q, mat, _ = _operands(dim)
    sims, _ = tk.matmul_blockmax(q, mat, ROWS)
    assert _within(sims, *tk.score_bound(q, mat))


@pytest.mark.parametrize("dim", DIMS)
def test_plain_k1_unit_maxima_within_bound(dim):
    q, mat, _ = _operands(dim)
    bms = tk.matmul_blockmax2_only(q, mat, ROWS, sub=UNIT)
    exact, bound = tk.score_bound(q, mat)
    # every score within its bound => the unit max within the unit's widest
    ex_u = exact.T.reshape(-1, UNIT, T).amax(dim=1)
    b_u = bound.T.reshape(-1, UNIT, T).amax(dim=1)
    assert _within(bms, ex_u, b_u)


@pytest.mark.parametrize("dim", DIMS)
def test_plain_k2_and_k6_scores_within_bound(dim):
    q, mat, ids = _operands(dim)
    rows = _unit_rows(mat, ids)
    exact, bound = tk.score_bound(q, rows)
    assert _within(tk.gather_rescore(q, mat, ids, unit=UNIT), exact, bound)
    assert _within(tk.block_scores(q, rows.contiguous()), exact, bound)


@pytest.mark.parametrize("dim", DIMS)
def test_plain_k13_scores_within_bound(dim):
    q, mat, ids = _operands(dim)
    out = tk.gather_cross(q, mat, ids, unit=UNIT, G=2)  # [3, T, 8*2*UNIT]
    groups = q.shape[0] // tk.CROSS_GROUP
    for j in range(out.shape[0]):
        # candidate c = (g*8 + r)*UNIT + s of group i: unit ids[8i + r, 2j + g]
        uid = ids[:, 2 * j:2 * j + 2].view(groups, tk.CROSS_GROUP, 2)
        uid = uid.transpose(1, 2).reshape(groups, -1)
        cand = _unit_rows(mat, uid)  # [groups, C, D]
        cand = cand.repeat_interleave(tk.CROSS_GROUP, dim=0)
        assert _within(out[j], *tk.score_bound(q, cand))


@pytest.mark.parametrize("dim", DIMS)
def test_bound_gathered_equals_dense(dim):
    """The per-query form ``[T, C, D]`` is the dense form at those rows."""
    q, mat, ids = _operands(dim)
    exact, bound = tk.score_bound(q, mat)
    g_exact, g_bound = tk.score_bound(q, _unit_rows(mat, ids))
    cols = (ids.long()[:, :, None] * UNIT + torch.arange(UNIT)).reshape(T, -1)
    assert torch.equal(g_exact, torch.gather(exact, 1, cols))
    assert torch.allclose(g_bound, torch.gather(bound, 1, cols), rtol=1e-12,
                          atol=0)


@pytest.mark.parametrize("dim", DIMS)
def test_wrong_fragment_layout_breaks_bound(dim):
    """Features d and d+8 of each k16 step swapped in the rows only — what
    an A fragment with its halves crossed would multiply — give scores far
    outside the bound, so the bound check sees a layout fault that the
    kernels' identities (K1 = K2 = K3) cannot."""
    q, mat, _ = _operands(dim)
    d = torch.arange(dim)
    swapped = torch.where((d % 16 < 8) & (d + 8 < dim), d + 8,
                          torch.where((d % 16 >= 8), d - 8, d))
    wrong = q.float() @ mat.float()[:, swapped].T
    exact, bound = tk.score_bound(q, mat)
    assert not _within(wrong, exact, bound)
    assert float(bound.max()) < 2.0 ** -10  # unit vectors: a tight bound
