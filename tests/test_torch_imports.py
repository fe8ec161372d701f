"""The PyTorch package imports without jax and without the JAX package.

Checked in a fresh interpreter: the suite's conftest imports jax
for every test, so ``sys.modules`` here says nothing about the port. A
``sys.meta_path`` finder refuses ``better_search_rag_rust_tpu``,
``scripts`` (whose prototypes import JAX) and their submodules, so an
import of either fails loudly even where that module would not have pulled
in jax.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_RUN = """
import importlib, pkgutil, sys

class BlockJaxPackage:
    def find_spec(self, name, path=None, target=None):
        if name in ("better_search_rag_rust_tpu", "scripts") or \
                name.startswith(("better_search_rag_rust_tpu.", "scripts.")):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, BlockJaxPackage())
import better_search_rag_rust_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its top-level imports only; main() is not run
import bench_torch  # likewise
for mod in ("utils.profiling", "bench.suite", "bench.jabref",
            "bench.proto_calib", "bench.proto_attn", "bench.proto_blockmax",
            "bench.proto_dma", "bench.proto_fused", "bench.proto_f32",
            "launch", "parallel.mesh", "utils.testing", "ops.flash_kernels"):
    assert port.__name__ + "." + mod in names, mod
from better_search_rag_rust_tpu_torch import native
from better_search_rag_rust_tpu_torch.models.tokenizer import HashingTokenizer
tok = HashingTokenizer(vocab_size=1000, max_tokens=16)
ids, mask = tok.encode_batch(["class A { int x; }"])
assert ids.shape == (1, 16) and mask.sum() > 2
from pathlib import Path
lib = native.library_path().resolve()
assert lib.parent == (Path.cwd() / "build" / "native").resolve(), lib
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "jaxlib", "flax", "triton", "better_search_rag_rust_tpu.")))
assert not bad, bad
assert "torch" in sys.modules and len(names) > 40, names
print("ok")
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("name", [
    "CorpusConfig", "EncoderConfig", "StoreConfig", "MeshConfig",
    "SearchConfig", "PipelineConfig",
])
def test_config_dataclasses_match_jax(name):
    """The port's config dataclasses have the JAX package's fields, order,
    annotations and defaults, so a config built by one drives the other."""
    from better_search_rag_rust_tpu import config as jcfg
    from better_search_rag_rust_tpu_torch import config as pcfg

    jcls, pcls = getattr(jcfg, name), getattr(pcfg, name)

    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert spec(pcls) == spec(jcls)
    assert pcfg.asdict(pcls()) == jcfg.asdict(jcls())


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no card — even when copied away from the repo."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
