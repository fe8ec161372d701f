"""The ``finetune`` measurement: contrastive train-step throughput.

Counterpart of ``run_finetune_suite`` (``better_search_rag_rust_tpu/bench/
suite.py:704-769``) at its shape: NomicBERT 12 layers x 768, batch 64 pairs
of 512 tokens, random weights from the seed, fixed batches, lr 1e-5. One
step is both towers' forward, the backward and AdamW. The step is timed on
the card with CUDA events over ``steps`` steps after three warm-up steps; no
host sync sits inside the timed window (the reference's two-point N-fit was
a workaround for its relay, and is not carried over).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.nomic import NomicBertConfig, _resolve_attention_impl
from ..models.train import ContrastiveTrainer
from ..ops import attention_kernels as ak
from ..utils.device import resolve_device


WARMUP_STEPS = 3


def run_finetune_suite(batch: int = 64, steps: int = 8, max_tokens: int = 512,
                       num_layers: int = 12, hidden: int = 768, seed: int = 0,
                       device: Optional[torch.device | str] = None) -> dict:
    """files/s and steps/s of :class:`ContrastiveTrainer` on the CUDA card,
    the final loss, the peak memory of the timed steps and the attention
    kernels' launches in them. Raises without a CUDA device: the timing is
    the card's."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the finetune measurement times a CUDA card; "
                           f"got device {device}")
    cfg = NomicBertConfig(max_tokens=max_tokens, num_layers=num_layers,
                          hidden_size=hidden, mlp_dim=4 * hidden)
    trainer = ContrastiveTrainer(cfg, learning_rate=1e-5, seed=seed,
                                 device=device)
    rng = np.random.default_rng(seed)
    shape = (batch, max_tokens)
    ids_a = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=shape)).to(device)
    ids_b = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=shape)).to(device)
    mask = torch.ones(shape, dtype=torch.int64, device=device)
    for _ in range(WARMUP_STEPS):
        trainer.train_step(ids_a, mask, ids_b, mask)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    ak.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        loss = trainer.train_step_device(ids_a, mask, ids_b, mask)
    end.record()
    torch.cuda.synchronize(device)
    elapsed = start.elapsed_time(end) / 1e3
    return {
        "metric": "finetune_files_per_sec",
        "value": batch * steps / elapsed,
        "unit": "files/sec",
        "steps_per_sec": steps / elapsed,
        "step_ms": 1e3 * elapsed / steps,
        "final_loss": float(loss),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
        "launches": dict(ak.launch_counts),
        "batch": batch,
        "steps": steps,
        "max_tokens": max_tokens,
        "attention_impl": _resolve_attention_impl(cfg.attention_impl,
                                                  max_tokens, cfg.head_dim),
        "devices": 1,
        "device": torch.cuda.get_device_name(device),
    }
