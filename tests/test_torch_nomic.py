"""The port's NomicBERT encoder, tokenizer and encoder service against the
JAX package on the same inputs (numpy seeds), at a small size: 2 layers,
hidden 64, 4 heads, S = 64.

Tolerances and why:
* f32 with the ``xla`` chain: atol 5e-4 and cosine > 0.99999 per row (the
  golden-parity bound of ``tests/test_golden_parity.py``: two f32
  implementations that sum in different orders);
* bf16 with ``fused`` (the port's plain K8 vs the JAX kernel in interpret
  mode) and ``xla_bf16``: cosine > 0.999 per row (bf16 rounds at other
  places in the two frameworks; the JAX package's own bound between its
  attention variants);
* the hash encoder: 1e-6 (one gather and an f32 mean in either package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_golden_parity import CFG, GOLDEN, synth_hf_state

from better_search_rag_rust_tpu.config import EncoderConfig
from better_search_rag_rust_tpu.models.encoder import (
    create_encoder as jax_create_encoder,
)
from better_search_rag_rust_tpu.models.hash_encoder import (
    HashEncoder as JaxHashEncoder,
)
from better_search_rag_rust_tpu.models.nomic import (
    NomicBertConfig as JaxConfig,
    NomicEncoder as JaxEncoder,
)
from better_search_rag_rust_tpu.models.tokenizer import (
    HashingTokenizer as JaxHashingTokenizer,
)
from better_search_rag_rust_tpu_torch.models import encoder as penc
from better_search_rag_rust_tpu_torch.models.hash_encoder import HashEncoder
from better_search_rag_rust_tpu_torch.models.nomic import (
    NomicBertConfig,
    NomicEncoder,
    _resolve_attention_impl,
    convert_hf_state,
    params_from_flax,
)
from better_search_rag_rust_tpu_torch.models.tokenizer import (
    HashingTokenizer,
    TokenizerError,
)

SMALL = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_tokens=64)


def _tokens(seed=5, batch=5, s=SMALL["max_tokens"], vocab=SMALL["vocab_size"]):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(batch, s)).astype(np.int32)
    mask = np.zeros((batch, s), np.int32)
    for b in range(batch - 1):
        n = int(rng.integers(4, s + 1))
        mask[b, :n] = 1
        ids[b, n:] = 0
    ids[-1] = 0                      # a zero-mask padding row
    return ids, mask


def _pair(jdtype, tdtype, impl, seed=3):
    jenc = JaxEncoder(JaxConfig(dtype=jdtype, attention_impl=impl, **SMALL),
                      seed=seed)
    sd = params_from_flax(jax.tree.map(np.asarray, jenc.params))
    penc_ = NomicEncoder(NomicBertConfig(dtype=tdtype, attention_impl=impl,
                                         **SMALL), state_dict=sd)
    return jenc, penc_


def _row_cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


def test_f32_xla_matches_jax():
    jenc, tenc = _pair(jnp.float32, torch.float32, "xla")
    ids, mask = _tokens()
    want = jenc.encode_tokens(ids, mask)
    got = tenc.encode_tokens(ids, mask)
    assert got.shape == want.shape == (5, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert _row_cos(got[:-1], want[:-1]).min() > 0.99999
    np.testing.assert_array_equal(got[-1], 0.0)   # zero-mask row pools to 0


@pytest.mark.parametrize("impl", ["fused", "xla_bf16"])
def test_bf16_matches_jax(impl):
    jenc, tenc = _pair(jnp.bfloat16, torch.bfloat16, impl)
    ids, mask = _tokens(seed=9)
    want = jenc.encode_tokens(ids, mask)          # fused: interpret mode
    got = tenc.encode_tokens(ids, mask)
    assert np.isfinite(got).all()
    cos = _row_cos(got[:-1], want[:-1])
    assert cos.min() > 0.999, cos


def test_hf_state_matches_committed_golden():
    blob = np.load(GOLDEN)
    cfg = NomicBertConfig(dtype=torch.float32, attention_impl="xla", **CFG)
    sd = convert_hf_state(synth_hf_state(int(blob["state_seed"])), cfg)
    got = NomicEncoder(cfg, state_dict=sd).encode_tokens(blob["ids"],
                                                         blob["mask"])
    want = blob["embeddings"]
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert _row_cos(got, want).min() > 0.99999


def test_hf_and_flax_routes_agree():
    """convert_hf_state and params_from_flax(convert_hf_params) give the
    same state dict: the two ways in."""
    from better_search_rag_rust_tpu.models.nomic import convert_hf_params

    state = synth_hf_state(7)
    cfg = NomicBertConfig(dtype=torch.float32, **CFG)
    a = convert_hf_state(state, cfg)
    jcfg = JaxConfig(dtype=jnp.float32, **CFG)
    b = params_from_flax(jax.tree.map(np.asarray,
                                      convert_hf_params(state, jcfg)))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(), key)


def test_attention_impl_resolution():
    assert _resolve_attention_impl("auto", 512, 64) == "fused"
    assert _resolve_attention_impl("fused", 60, 64) == "xla_bf16"
    assert _resolve_attention_impl("fused", 64, 12) == "xla_bf16"
    assert _resolve_attention_impl("xla", 60, 12) == "xla"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _resolve_attention_impl("flash")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NomicEncoder(NomicBertConfig(attention_impl="flash", **SMALL))
    svc = penc.create_encoder(EncoderConfig(
        backend="nomic", dim=64, num_layers=1, num_heads=4, mlp_dim=64,
        max_tokens=64, vocab_size=211))
    assert svc.numerics["attention_impl"] == "torch-fused"
    jsvc = jax_create_encoder(EncoderConfig(
        backend="nomic", dim=64, num_layers=1, num_heads=4, mlp_dim=64,
        max_tokens=64, vocab_size=211))
    assert jsvc.numerics["attention_impl"] == "fused"  # the two differ
    assert {k for k in svc.numerics} == {k for k in jsvc.numerics}


TEXTS = [
    "public class VectorStore { void append(float[] row) {} }",
    "def cosine(a, b): return a @ b  # ascii only",
    "naïve café — ünïcödé wörds and 数据 tokens",
    "tab\tseparated\nlines and punctuation!?;",
]


@pytest.mark.parametrize("texts", [TEXTS[:2], TEXTS, [TEXTS[2]]])
def test_tokenizer_ids_bitwise(texts):
    tok, jtok = HashingTokenizer(1000, 16), JaxHashingTokenizer(1000, 16)
    for a, b in zip(tok.encode_batch(texts), jtok.encode_batch(texts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tokenizer_windows_bitwise():
    long_text = " ".join(f"w{i}" for i in range(40)) + " ünï"
    texts = [long_text, "short one"]
    tok, jtok = HashingTokenizer(1000, 16), JaxHashingTokenizer(1000, 16)
    for a, b in zip(tok.encode_batch_windows(texts),
                    jtok.encode_batch_windows(texts)):
        np.testing.assert_array_equal(a, b)
    assert tok.encode_batch([])[0].shape == (0, 16)
    with pytest.raises(TokenizerError, match="has empty values"):
        tok.encode_batch(["x", ""])


def test_hash_encoder_matches_jax():
    ids, mask = _tokens(seed=2, vocab=500)
    got = HashEncoder(dim=32, max_tokens=64, vocab_size=500).encode_tokens(
        ids, mask)
    want = JaxHashEncoder(dim=32, max_tokens=64, vocab_size=500).encode_tokens(
        ids, mask)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _service(backend, **kw):
    cfg = EncoderConfig(backend=backend, dim=64, num_layers=1, num_heads=4,
                        mlp_dim=64, max_tokens=32, vocab_size=211,
                        batch_size=4, dtype="float32",
                        attention_impl="xla", **kw)
    return penc.create_encoder(cfg), jax_create_encoder(cfg)


def test_encoder_contract_empty_inputs():
    svc, _ = _service("nomic")
    out = svc.get_embeddings([])
    assert out.shape == (0, 64) and out.dtype == np.float32
    with pytest.raises(TokenizerError, match="has empty values"):
        svc.get_embeddings(["fine", ""])


def test_encoder_fixed_batch_padding():
    """Five texts at batch_size 4: two device batches, the second padded
    with zero-mask rows; each row equals the text encoded alone."""
    svc, _ = _service("nomic")
    texts = [f"text number {i} " * (i + 1) for i in range(5)]
    both = svc.get_embeddings(texts)
    assert both.shape == (5, 64)
    alone = np.concatenate([svc.get_embeddings([t]) for t in texts])
    np.testing.assert_allclose(both, alone, atol=1e-6)
    dev = svc.get_embeddings_device(texts)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), both)


def test_encoder_long_doc_mean_matches_jax():
    svc, jsvc = _service("hash", long_doc="mean")
    texts = [" ".join(f"tok{i % 97}" for i in range(150)), "tiny"]
    got = svc.get_embeddings(texts)
    want = jsvc.get_embeddings(texts)
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert svc.get_embeddings_device(texts) is None  # host-side window pool
