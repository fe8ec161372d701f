"""The encoder's local data-parallel mesh against the JAX package: a batch
split over a process's shards (the JAX ``NomicEncoder(mesh=...)`` and
``Pipeline._local_encode_mesh``), on CPU shards.

Tolerances and why: the port over 2 CPU shards against one shard, 1e-6 in
f32 and 2e-3 in bf16 (each block is the same rows' forward at half the
batch; measured 0 on this CPU, and a GEMM may pick another blocking at
another row count); against the JAX encoder over 2 emulated devices on the
same weights, the bounds of ``test_torch_nomic.py``'s encoder parity
(1e-5 f32; cosine 0.999 per row in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import (
    CorpusConfig,
    EncoderConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.models.encoder import (
    create_encoder as jax_create_encoder,
)
from better_search_rag_rust_tpu.models.nomic import (
    NomicBertConfig as JaxConfig,
    NomicEncoder as JaxEncoder,
)
from better_search_rag_rust_tpu.parallel import create_mesh as jax_mesh
from better_search_rag_rust_tpu.pipeline import Pipeline as JaxPipeline
from better_search_rag_rust_tpu_torch import pipeline as ppipe
from better_search_rag_rust_tpu_torch.models.encoder import create_encoder
from better_search_rag_rust_tpu_torch.models.nomic import (
    NomicBertConfig,
    NomicEncoder,
    params_from_flax,
)
from better_search_rag_rust_tpu_torch.parallel.mesh import create_mesh
from better_search_rag_rust_tpu_torch.pipeline import Pipeline
from better_search_rag_rust_tpu_torch.store import vectorstore as pvs

SMALL = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_tokens=32)
SHARD_TOL = {"float32": 1e-6, "bfloat16": 2e-3}


def _tokens(b=8, s=32, vocab=211, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.int32)
    for row in range(b):
        n = int(rng.integers(4, s + 1))
        mask[row, :n] = 1
        ids[row, n:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_over_local_shards(dtype):
    """2 CPU shards (a device named twice, one copy of the weights): equal
    to one shard within SHARD_TOL, and to the JAX encoder over 2 emulated
    devices. A batch that does not split raises."""
    jenc = JaxEncoder(JaxConfig(dtype=jnp.dtype(dtype), **SMALL), seed=3,
                      mesh=jax_mesh(devices=jax.devices()[:2]))
    sd = params_from_flax(jax.tree.map(np.asarray, jenc.params))
    cfg = NomicBertConfig(dtype=getattr(torch, dtype), **SMALL)
    two = NomicEncoder(cfg, state_dict=sd,
                       mesh=create_mesh(devices=["cpu", "cpu"]))
    one = NomicEncoder(cfg, state_dict=sd, device="cpu")
    assert len(two._models) == 1 and two.devices == [torch.device("cpu")] * 2
    ids, mask = _tokens()
    got = two.encode_tokens(ids, mask)
    np.testing.assert_allclose(got, one.encode_tokens(ids, mask),
                               atol=SHARD_TOL[dtype], rtol=0)
    want = jenc.encode_tokens(ids, mask)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        assert cos.min() > 0.999, cos
    with pytest.raises(ValueError, match="does not split"):
        two.encode_tokens(ids[:7], mask[:7])


def _enc_cfg(batch_size, backend="nomic"):
    return EncoderConfig(backend=backend, dim=64, num_layers=1, num_heads=4,
                         mlp_dim=64, max_tokens=32, vocab_size=211,
                         batch_size=batch_size, dtype="float32")


def test_create_encoder_records_dp_devices():
    """``dp_devices`` as the JAX package records it: the local shards of a
    mesh that splits the batch, absent on one device; a batch size that
    does not divide the shards raises the JAX package's error."""
    mesh, jmesh = create_mesh(devices=["cpu"] * 4), jax_mesh(
        devices=jax.devices()[:4])
    svc = create_encoder(_enc_cfg(8), mesh=mesh)
    jsvc = jax_create_encoder(_enc_cfg(8), mesh=jmesh)
    assert svc.numerics["dp_devices"] == jsvc.numerics["dp_devices"] == 4
    assert "dp_devices" not in create_encoder(_enc_cfg(8),
                                              device="cpu").numerics
    assert "dp_devices" not in jax_create_encoder(_enc_cfg(8)).numerics
    for make, m in ((create_encoder, mesh), (jax_create_encoder, jmesh)):
        with pytest.raises(ValueError, match="batch_size 6 does not divide "
                                             "over the 4-device mesh"):
            make(_enc_cfg(6), mesh=m)
    # the hash backend runs no model: no mesh, no record, no error
    assert "dp_devices" not in create_encoder(
        _enc_cfg(6, "hash"), device="cpu", mesh=mesh).numerics
    texts = [f"class A{i} {{ int x = {i}; }}" for i in range(11)]
    np.testing.assert_allclose(
        svc.get_embeddings(texts),
        create_encoder(_enc_cfg(8), device="cpu").get_embeddings(texts),
        atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(0)
    for i in range(20):
        body = " ".join(f"tok{rng.integers(0, 5000)}" for _ in range(40))
        (root / f"F{i}.java").write_text(f"class F{i} {{ {body} }}")
    return root


def _pipe_cfg(root, store_dir, batch_size, backend="nomic"):
    return PipelineConfig(
        corpus=CorpusConfig(root=str(root), files_per_batch=8),
        encoder=_enc_cfg(batch_size, backend),
        store=StoreConfig(dir=str(store_dir)),
        search=SearchConfig(top_k=5, query_idx=3))


def test_pipeline_encodes_over_its_local_shards(tree, tmp_path):
    """A pipeline whose mesh holds 2 of this process's shards builds the
    store with every batch split over them: its rows equal a one-shard
    build's within SHARD_TOL, and its encoder meta records dp_devices 2."""
    two = Pipeline(_pipe_cfg(tree, tmp_path / "two", 4), device="cpu",
                   mesh=create_mesh(devices=["cpu", "cpu"]))
    res = two.run()
    assert (res.mrr, res.recall, res.overlap) == (1.0, 1.0, 1.0)
    assert two.encoder.numerics["dp_devices"] == 2
    assert pvs.load_encoder_meta(tmp_path / "two")["dp_devices"] == 2
    one = Pipeline(_pipe_cfg(tree, tmp_path / "one", 4), device="cpu")
    one.run()
    assert "dp_devices" not in one.encoder.numerics
    got = pvs.global_store(tmp_path / "two", empty=False).matrix()
    want = pvs.global_store(tmp_path / "one", empty=False).matrix()
    assert got.shape == want.shape == (20, 64)
    np.testing.assert_allclose(got, want, atol=SHARD_TOL["float32"], rtol=0)


def test_local_encode_mesh_conditions(tree, tmp_path, monkeypatch):
    """The JAX package's conditions: a batch size that does not divide the
    local shards encodes on one device, with its log line; the hash
    backend and a mesh of one local shard take no mesh."""
    logs = []
    monkeypatch.setattr(ppipe, "host_log", logs.append)
    mesh = create_mesh(devices=["cpu"] * 8)
    odd = Pipeline(_pipe_cfg(tree, tmp_path / "a", 3), device="cpu",
                   mesh=mesh)
    assert odd._local_encode_mesh() is None
    assert "dp_devices" not in odd.encoder.numerics
    want = ("encode batch_size 3 does not divide 8 local devices; encoding "
            "on one")
    assert logs.count(want) == 2
    # the JAX pipeline over its 8 emulated devices: the same decisions
    jlogs = []
    import better_search_rag_rust_tpu.pipeline as jpipe

    monkeypatch.setattr(jpipe, "host_log", jlogs.append)
    assert JaxPipeline(_pipe_cfg(tree, tmp_path / "j", 3))._local_encode_mesh(
        ) is None
    assert jlogs == [want]
    assert JaxPipeline(_pipe_cfg(tree, tmp_path / "j", 8)
                       )._local_encode_mesh().size == 8
    assert Pipeline(_pipe_cfg(tree, tmp_path / "b", 8), device="cpu",
                    mesh=mesh)._local_encode_mesh() is mesh
    assert Pipeline(_pipe_cfg(tree, tmp_path / "c", 8, "hash"),
                    device="cpu", mesh=mesh)._local_encode_mesh() is None
    assert JaxPipeline(_pipe_cfg(tree, tmp_path / "j", 8, "hash")
                       )._local_encode_mesh() is None
    assert Pipeline(_pipe_cfg(tree, tmp_path / "d", 8),
                    device="cpu")._local_encode_mesh() is None
