"""The PyTorch package imports without jax.

Checked in a fresh interpreter: the suite's conftest imports jax
for every test, so ``sys.modules`` here says nothing about the port.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import better_search_rag_rust_tpu_torch\n"
        "import better_search_rag_rust_tpu_torch.ops.engine\n"
        "import better_search_rag_rust_tpu_torch.ops.topk_kernels\n"
        "import better_search_rag_rust_tpu_torch.pipeline\n"
        "import better_search_rag_rust_tpu_torch.cli\n"
        "import better_search_rag_rust_tpu_torch.store\n"
        "import better_search_rag_rust_tpu_torch.bench\n"
        "import better_search_rag_rust_tpu_torch.corpus\n"
        "import better_search_rag_rust_tpu_torch.models\n"
        "import better_search_rag_rust_tpu_torch.models.encoder\n"
        "import better_search_rag_rust_tpu_torch.models.hash_encoder\n"
        "import better_search_rag_rust_tpu_torch.models.nomic\n"
        "import better_search_rag_rust_tpu_torch.models.tokenizer\n"
        "import better_search_rag_rust_tpu_torch.models.train\n"
        "import better_search_rag_rust_tpu_torch.models.train_data\n"
        "import better_search_rag_rust_tpu_torch.models.checkpoint\n"
        "import better_search_rag_rust_tpu_torch.bench.finetune\n"
        "import better_search_rag_rust_tpu_torch.utils.device\n"
        "import better_search_rag_rust_tpu_torch.ops.attention_kernels\n"
        "import better_search_rag_rust_tpu_torch.ops._build\n"
        "import better_search_rag_rust_tpu_torch.store.vectorstore\n"
        "import better_search_rag_rust_tpu_torch.store.device_cache\n"
        "import better_search_rag_rust_tpu_torch.batcher\n"
        "import better_search_rag_rust_tpu_torch.bench.serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'jaxlib', 'flax', 'triton')))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


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
