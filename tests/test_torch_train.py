"""The port's training slice against the JAX package on the same inputs
(numpy seeds), at a small size: the contrastive trainer, its loss, the
training-data batches, the checkpoint and the ``finetune`` CLI.

Tolerances and why:
* ``info_nce_loss``: 1e-6 (the same f32 algebra; one matrix product);
* model gradients against JAX's, the same weights: cosine > 0.999999 per
  parameter in f32 (sums in other orders), > 0.999 in bf16 (bf16 rounds
  at other places, and the differences compound down the backward;
  measured >= 0.99985 here, the lowest on a bias of the first layer);
* model gradients, ``fused`` (K8 + the plain K9 backward) against ``xla``
  (autograd of the plain f32-logit chain), bf16 compute: cosine > 0.99 per
  parameter, the JAX package's own bound for its kernel's VJP
  (``tests/test_models.py:455-502``);
* the trainers over 3 steps from the same parameters and batches (JAX on a
  (1, 1) mesh, where it takes its fused custom-VJP arm): f32 loss to 1e-4
  (measured <= 3.1e-6: sums in other orders, then three AdamW steps), bf16
  to 5e-3 (measured <= 1.6e-3: bf16 rounds at other places in the two
  frameworks, e.g. the embedding gradient accumulates in f32 here, in bf16
  in JAX);
* batches, checkpoints: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.models.nomic import (
    NomicBertConfig as JaxConfig,
    NomicBertModel as JaxModel,
)
from better_search_rag_rust_tpu.models.tokenizer import (
    HashingTokenizer as JaxHashingTokenizer,
)
from better_search_rag_rust_tpu.models.train import (
    ContrastiveTrainer as JaxTrainer,
    info_nce_loss as jax_info_nce_loss,
)
from better_search_rag_rust_tpu.models.train_data import (
    corpus_pair_batches as jax_corpus_pair_batches,
)
from better_search_rag_rust_tpu.parallel import create_mesh
from better_search_rag_rust_tpu_torch import cli
from better_search_rag_rust_tpu_torch.models.checkpoint import (
    load_params,
    save_params,
)
from better_search_rag_rust_tpu_torch.models.nomic import (
    NomicBertConfig,
    NomicBertModel,
    init_random,
    params_from_flax,
)
from better_search_rag_rust_tpu_torch.models.tokenizer import HashingTokenizer
from better_search_rag_rust_tpu_torch.models.train import (
    ContrastiveTrainer,
    info_nce_loss,
)
from better_search_rag_rust_tpu_torch.models.train_data import (
    corpus_pair_batches,
    pairs_from_texts,
)
from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

TINY = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
            mlp_dim=64, max_tokens=8)
SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_tokens=32)
LOSS_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
GRAD_COS_JAX = {"float32": 0.999999, "bfloat16": 0.999}


def _batch(b, s, vocab, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    p = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    am = np.ones((b, s), np.int32)
    pm = np.ones((b, s), np.int32)
    am[1, s * 5 // 8:] = 0
    pm[2, s // 4:] = 0
    return a, am, p, pm


def test_info_nce_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((12, 48)).astype(np.float32)
    p = rng.standard_normal((12, 48)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    for t in (0.05, 1.0):
        want = float(jax_info_nce_loss(jnp.asarray(a), jnp.asarray(p), t))
        got = float(info_nce_loss(torch.from_numpy(a), torch.from_numpy(p), t))
        assert abs(got - want) <= 1e-6, (t, got, want)
    same = info_nce_loss(torch.eye(8, 16), torch.eye(8, 16))
    assert float(same) < float(info_nce_loss(torch.eye(8, 16),
                                             torch.eye(8, 16).roll(1, 0)))


def test_fused_gradients_match_xla():
    """Parameter gradients through K8 + the plain K9 against autograd of
    the plain f32-logit attention, the same f32 weights and bf16 compute
    (ports tests/test_models.py:455-502)."""
    cfg = NomicBertConfig(vocab_size=256, hidden_size=64, num_layers=2,
                          num_heads=4, mlp_dim=128, max_tokens=64,
                          attention_impl="fused", param_dtype=torch.float32)
    fused = NomicBertModel(cfg)
    init_random(fused, 0)
    plain = NomicBertModel(dataclasses.replace(cfg, attention_impl="xla"))
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(1, 256, size=(2, 64)))
    mask = torch.ones((2, 64), dtype=torch.int64)
    mask[1, 40:] = 0
    probe = torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(np.float32))
    for model in (fused, plain):
        (model(ids, mask).float() * probe).sum().backward()
    checked = 0
    for (name, pf), (_, px) in zip(fused.named_parameters(),
                                   plain.named_parameters()):
        assert pf.dtype == px.grad.dtype == torch.float32
        a, b = pf.grad.double().ravel(), px.grad.double().ravel()
        if a.norm() < 1e-6 and b.norm() < 1e-6:
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > 0.99, (name, cos)
        checked += 1
    assert checked > 10
    assert fused.encoder.layers[0].attn.Wqkv.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_gradients_match_jax(dtype):
    """Every parameter's gradient through the fused model (K8 forward, the
    plain K9 backward) against JAX's (its kernel and custom VJP in
    interpret mode), the same f32 weights carried across."""
    s = SMALL["max_tokens"]
    jm = JaxModel(JaxConfig(dtype=jnp.dtype(dtype), attention_impl="fused",
                            **SMALL))
    a, am, _, _ = _batch(3, s, SMALL["vocab_size"], seed=6)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(a),
                     jnp.asarray(am))["params"]
    probe = np.random.default_rng(7).standard_normal(
        (3, s, SMALL["hidden_size"])).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jm.apply(
        {"params": p}, jnp.asarray(a), jnp.asarray(am)).astype(jnp.float32)
        * probe))(params)
    want = params_from_flax(jax.tree.map(np.asarray, want))
    tm = NomicBertModel(NomicBertConfig(dtype=getattr(torch, dtype),
                                        attention_impl="fused",
                                        param_dtype=torch.float32, **SMALL))
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    (tm(torch.from_numpy(a), torch.from_numpy(am)).float()
     * torch.from_numpy(probe)).sum().backward()
    bound = GRAD_COS_JAX[dtype]
    for name, p in tm.named_parameters():
        x, y = p.grad.double().ravel(), want[name].double().ravel()
        if float(y.norm()) == 0.0:           # the unused token-type row
            assert float(x.norm()) == 0.0, name
            continue
        assert float(x @ y / (x.norm() * y.norm())) > bound, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_tracks_jax_trainer(dtype):
    jcfg = JaxConfig(dtype=jnp.dtype(dtype), attention_impl="fused", **SMALL)
    s = SMALL["max_tokens"]
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, s), jnp.int32),
                                 jnp.ones((1, s), jnp.int32))["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    mesh = create_mesh(shape=(1, 1), axis_names=("data", "model"),
                       devices=jax.devices()[:1])
    jt = JaxTrainer(jcfg, mesh, learning_rate=1e-3, params=params)
    tcfg = NomicBertConfig(dtype=getattr(torch, dtype), attention_impl="fused",
                           **SMALL)
    tt = ContrastiveTrainer(tcfg, learning_rate=1e-3, params=sd, device="cpu")
    batch = _batch(8, s, SMALL["vocab_size"])
    want = [jt.train_step(*batch) for _ in range(3)]
    got = [tt.train_step(*batch) for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL[dtype], rtol=0)
    assert got[-1] < got[0] and tt.step == 3


def test_trainer_state_is_f32_with_optax_defaults():
    tr = ContrastiveTrainer(NomicBertConfig(**TINY), device="cpu")
    assert tr.config.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in tr.state.params.values())
    group = tr.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 1e-4)
    ids = np.ones((4, 8), np.int32)
    tr.train_step(ids, ids, ids, ids)
    moments = [t for st in tr.optimizer.state.values() for k, t in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    assert tr.state.step == 1


def test_train_step_decreases_loss():
    """Ports tests/test_train.py:82-90."""
    tr = ContrastiveTrainer(NomicBertConfig(**TINY), learning_rate=1e-3,
                            device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, size=(8, 8)).astype(np.int32)
    mask = np.ones((8, 8), np.int32)
    before = ak.launch_counts["fused_attention_qkv_bwd"]
    losses = [tr.train_step(ids, mask, ids, mask) for _ in range(4)]
    assert ak.launch_counts["fused_attention_qkv_bwd"] == before  # plain
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    assert tr.state.step == 4


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContrastiveTrainer(NomicBertConfig(**TINY))
    from better_search_rag_rust_tpu_torch.bench.finetune import (
        run_finetune_suite,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        run_finetune_suite(device="cpu")


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """Ports tests/test_train.py:302-324: bitwise round trip, then one
    finite step from the restored parameters."""
    tr = ContrastiveTrainer(NomicBertConfig(**TINY), device="cpu")
    ids = np.ones((8, 8), np.int32)
    tr.train_step(ids, ids, ids, ids)
    path = tmp_path / "ckpt"
    save_params(path, tr.state.params)
    save_params(path, tr.state.params)            # overwrites in place
    restored = load_params(path, like=tr.state.params)
    assert restored.keys() == tr.state.params.keys()
    for name, t in tr.state.params.items():
        assert restored[name].dtype == t.dtype
        assert torch.equal(restored[name], t), name
    assert all(torch.equal(a, b) for a, b in zip(
        load_params(path).values(), restored.values()))
    resumed = ContrastiveTrainer(NomicBertConfig(**TINY), params=restored,
                                 device="cpu")
    assert np.isfinite(resumed.train_step(ids, ids, ids, ids))
    bad = dict(tr.state.params)
    bad.pop("emb_ln.bias")
    with pytest.raises(KeyError, match="emb_ln.bias"):
        load_params(path, like=bad)


def _tree(root, files, words):
    root.mkdir()
    for i in range(files):
        body = " ".join(f"tok{i}_{j}" for j in range(words))
        (root / f"F{i}.java").write_text(f"class F{i} {{ {body} }}")


def test_corpus_pair_batches_equal_jax(tmp_path):
    """Ports tests/test_train.py:327-354, and holds every array to the JAX
    package's for the same tree, tokenizer and seed."""
    root = tmp_path / "src"
    _tree(root, 9, 40)
    tok, jtok = HashingTokenizer(512, 16), JaxHashingTokenizer(512, 16)
    for seed in (0, 3):
        got = list(corpus_pair_batches(str(root), ("java",), tok, 4,
                                       seed=seed, epochs=2))
        want = list(jax_corpus_pair_batches(str(root), ("java",), jtok, 4,
                                            seed=seed, epochs=2))
        assert len(got) == len(want) == 4   # 2 full batches x 2 epochs
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == (4, 16)
                np.testing.assert_array_equal(a, b)
    a_i, _, p_i, _ = pairs_from_texts([" ".join(f"w{j}" for j in range(100))],
                                      tok, seed=1)
    assert not np.array_equal(a_i, p_i)      # two windows of one file
    with pytest.raises(ValueError, match="batch_size"):
        next(corpus_pair_batches(str(root), ("java",), tok, 10))


def test_cli_finetune(tmp_path, capsys):
    """Ports tests/test_train.py:357-376 on the CPU; ``--tp 2`` over one
    process exits with the JAX package's message (two ranks:
    ``test_torch_train_parallel.py``)."""
    root = tmp_path / "src"
    _tree(root, 8, 30)
    argv = ["finetune", "--root", str(root), "--steps", "3",
            "--train-batch", "4", "--dim", "32", "--max-tokens", "16",
            "--encoder-backend", "hash", "--num-layers", "1",
            "--num-heads", "2", "--mlp-dim", "64", "--device", "cpu",
            "--save-dir", str(tmp_path / "ckpt")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "final loss" in out
    assert f"params saved to {tmp_path / 'ckpt'}" in out
    params = load_params(tmp_path / "ckpt")
    assert params["encoder.layers.0.attn.Wqkv.weight"].shape == (96, 32)
    with pytest.raises(SystemExit, match="--tp 2 does not divide 1 devices"):
        cli.main(argv[:-2] + ["--tp", "2"])
