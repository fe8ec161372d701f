"""One world of ranks training over ``(data, model)`` meshes: the first
step's loss and gradients held to the one-process trainer's, then timed
steps and the attention kernels' launches on every rank.

Run it on every rank of a world joined through the ``BSR_*`` env
(:mod:`..launch`); each mesh covers the whole world, one shard a rank::

    BSR_COORDINATOR=127.0.0.1:29500 BSR_NUM_PROCESSES=4 BSR_PROCESS_ID=<r> \\
        python -m better_search_rag_rust_tpu_torch.bench.train_parallel \\
        --meshes 2x2 --out result.json

For each mesh (NomicBERT 12 x 768 by default, random weights from
``--seed``, ``--batch`` seeded pairs of ``--max-tokens`` tokens with
ragged masks, the same global batch on every rank):

* the first step's loss and whole gradients (gathered over the model
  group) beside the one-process trainer's on rank 0's device, from the
  same weights and batch: the loss difference, the least per-parameter
  cosine and the largest relative difference of a gradient's norm (which
  a gradient scaled by the data axis would show);
* the attention kernels each rank launched in that step (K8
  ``fused_attention_qkv`` and K9 ``fused_attention_qkv_bwd``, counted on
  CUDA only);
* ``--steps`` optimizer steps from there: their losses and, on every rank,
  steps/s by the host clock around work that ends in a synchronize (ranks
  that share a card time the card shared), and their launches per step.

Rank 0 writes one JSON object to ``--out``: the list of meshes' results.
``--device cpu`` (with small ``--num-layers``/``--hidden``/
``--max-tokens``) runs the same on gloo CPU ranks.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..launch import maybe_init_distributed
from ..models.nomic import NomicBertConfig
from ..models.train import ContrastiveTrainer
from ..ops import attention_kernels as ak
from ..parallel.collectives import REDUCE_SCATTER
from ..parallel.mesh import barrier, create_mesh, gather_objects, process_info
from ..utils.device import resolve_device

KERNELS = ("fused_attention_qkv", "fused_attention_qkv_bwd")


def seeded_pairs(seed: int, cfg: NomicBertConfig, batch: int) -> list:
    """``[a_ids, a_mask, p_ids, p_mask]`` int64 numpy arrays of ``batch``
    pairs: ids from ``[1, vocab)``, each row's mask a prefix of
    ``S/8 .. S`` tokens."""
    rng = np.random.default_rng(seed)
    s = cfg.max_tokens
    out = []
    for _ in range(2):
        ids = rng.integers(1, cfg.vocab_size, size=(batch, s))
        lens = rng.integers(s // 8, s + 1, size=batch)
        out += [ids, (np.arange(s)[None, :] < lens[:, None]).astype(np.int64)]
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gradient_agreement(got: dict, want: dict) -> dict:
    """The least per-parameter cosine of ``got`` against ``want`` (and its
    parameter), the largest ``|norm(got) / norm(want) - 1|`` and the
    number of parameters compared (those with a gradient in ``want``)."""
    worst, norm_dev, checked = (1.0, ""), 0.0, 0
    for name, w in want.items():
        x, y = got[name].double().ravel(), w.double().ravel()
        ny = float(y.norm())
        if ny == 0.0:
            continue
        nx = float(x.norm())
        cos = float(x @ y) / (nx * ny) if nx else 0.0
        worst = min(worst, (cos, name))
        norm_dev = max(norm_dev, abs(nx / ny - 1.0))
        checked += 1
    return {"min_cos": worst[0], "min_cos_param": worst[1],
            "max_norm_dev": norm_dev, "params": checked}


def run_mesh(shape, cfg: NomicBertConfig, batch: list, steps: int, seed: int,
             device: torch.device) -> dict:
    """One mesh of the world (every rank calls it): see the module doc.
    Rank 0 returns the whole result; the other ranks their own part."""
    rank, _world = process_info()
    mesh = create_mesh(tuple(shape), ("data", "model"), devices=[device])
    tr = ContrastiveTrainer(cfg, learning_rate=1e-5, seed=seed, mesh=mesh)
    _sync(device)
    ak.reset_launch_counts()
    loss0 = float(tr.backward(*batch))
    first = {k: ak.launch_counts[k] for k in KERNELS}
    grads = tr.gradients()
    check = None
    if rank == 0:
        ref = ContrastiveTrainer(cfg, learning_rate=1e-5, seed=seed,
                                 device=device)
        ref_loss = float(ref.backward(*batch))
        want = {n: p.grad for n, p in ref.model.named_parameters()}
        check = {"loss": loss0, "one_process_loss": ref_loss,
                 **gradient_agreement(grads, want)}
        del ref, want
    del grads
    if device.type == "cuda":
        torch.cuda.empty_cache()
    barrier("first step checked")
    _sync(device)
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [tr.train_step_device(*batch) for _ in range(steps)]
    _sync(device)
    elapsed = time.perf_counter() - t0
    mine = {"rank": rank, "device": str(tr.device),
            "first_step_launches": first,
            "launches_per_step": {k: ak.launch_counts[k] / steps
                                  for k in KERNELS},
            "steps_per_sec": steps / elapsed,
            "losses": [float(x) for x in losses]}
    ranks = gather_objects(mine)
    return {"mesh": list(shape), "sequence_parallel": tr.sequence_parallel,
            "heads_split": tr.heads_split,
            "attention_impl": tr.config.attention_impl,
            "collective": (REDUCE_SCATTER if tr.sequence_parallel
                           else "all_reduce"),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "batch": len(batch[0]), "steps": steps, "check": check,
            "ranks": ranks}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="2x1",
                    help="comma-separated DATAxMODEL shapes, each covering "
                         "the world")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-layers", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--max-tokens", type=int, default=512)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not maybe_init_distributed():
        raise SystemExit("train_parallel runs on the ranks of a world: set "
                         "BSR_COORDINATOR, BSR_NUM_PROCESSES, "
                         "BSR_PROCESS_ID")
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    cfg = NomicBertConfig(num_layers=args.num_layers, hidden_size=args.hidden,
                          mlp_dim=4 * args.hidden, max_tokens=args.max_tokens)
    batch = seeded_pairs(args.seed, cfg, args.batch)
    results: List[dict] = []
    for spec in args.meshes.split(","):
        shape = tuple(int(x) for x in spec.split("x"))
        results.append(run_mesh(shape, cfg, batch, args.steps, args.seed,
                                device))
    if process_info()[0] == 0:
        with open(args.out, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
