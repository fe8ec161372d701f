"""The ``finetune`` measurement: contrastive train-step throughput.

Counterpart of ``run_finetune_suite`` (``better_search_rag_rust_tpu/bench/
suite.py:704-769``) at its shape: NomicBERT 12 layers x 768, batch 64 pairs
of 512 tokens, random weights from the seed, fixed batches, lr 1e-5. One
step is both towers' forward, the backward and AdamW. The step is timed on
the card with CUDA events over ``steps`` steps after three warm-up steps,
:data:`.suite.REPEATS` times; no host sync sits inside a timed window (the
reference's two-point N-fit was a workaround for its relay, and is not
carried over). ``value`` is the best window's files/s; ``launches`` counts
the attention kernels of one window. ``mfu`` counts 3x the two towers'
forward FLOPs (fwd:bwd = 1:2), as the reference does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.nomic import NomicBertConfig, _resolve_attention_impl
from ..models.train import ContrastiveTrainer
from ..ops import attention_kernels as ak
from ..utils.device import resolve_device
from .suite import (
    REPEATS,
    _mfu,
    _platform,
    _spread_pct,
    encoder_forward_flops,
)


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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    secs = []
    for _ in range(REPEATS):
        ak.reset_launch_counts()
        start.record()
        for _ in range(steps):
            loss = trainer.train_step_device(ids_a, mask, ids_b, mask)
        end.record()
        torch.cuda.synchronize(device)
        secs.append(start.elapsed_time(end) / 1e3)
    elapsed = min(secs)
    repeats = [batch * steps / s for s in secs]
    flops = 3 * 2 * encoder_forward_flops(cfg, batch, max_tokens) * steps
    return {
        "metric": "finetune_files_per_sec",
        "value": batch * steps / elapsed,
        "unit": "files/sec",
        "vs_baseline": 0.0,
        **_mfu(flops / elapsed, "bfloat16", device),
        "files_per_sec_repeats": repeats,
        "spread_pct": _spread_pct(repeats),
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
        **_platform(device),
    }
