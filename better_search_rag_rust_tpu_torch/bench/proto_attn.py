"""A/B of one layer's attention core at the serving shape: the plain
head-major chain, K8 on the Wqkv layout, and K7 head-major.

    python -m better_search_rag_rust_tpu_torch.bench.proto_attn
    python -m better_search_rag_rust_tpu_torch.bench.proto_attn \\
        --device cpu --batch 2 --seq 64          # plain versions, small

Counterpart of ``scripts/proto_attn.py`` at its shape (B 256, H 12, S 512,
hd 64, bf16 ``qkv [B, S, 3 H hd]`` from ``--seed``, zero key bias):

* ``chain`` — the ``xla_bf16`` attention chain in PyTorch (rotary in bf16,
  bf16 logits times bf16 scale plus the bias, softmax in f32, bf16 probs,
  bf16 context), the reference's yardstick;
* ``fused_qkv`` — K8 ``fused_attention_qkv`` on the ``[B, S, 2304]`` layout,
  no transposes;
* ``fused_hm`` — K7 ``fused_attention`` on head-major ``[B, H, S, hd]``
  q, k and v, with the transposes its caller pays (into head-major and the
  context back).

Each is timed with CUDA events, best of :data:`ROUNDS` interleaved rounds
of :data:`ITERS` calls, and compared with the chain by cosine. K7 and K8 compute
one function per head: their outputs must agree bit for bit, and the run
fails otherwise. The last line is ``launches {...}``: the K7 and K8 launches
of the timed rounds.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..models.nomic import apply_rotary, rotary_tables
from ..ops import attention_kernels as ak

ROUNDS = 3
ITERS = 8
#: cosine of each fused output against the bf16 chain, at least
MIN_COS = 0.999


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device
    from .suite import _device_seconds

    device = resolve_device(args.device)
    b, s, h, hd = args.batch, args.seq, 12, 64
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    qkv = torch.randn((b, s, 3 * h * hd), generator=gen,
                      device=device).to(torch.bfloat16)
    cos_np, sin_np = rotary_tables(s, hd, 1000.0)
    cos = torch.from_numpy(cos_np).to(device)
    sin = torch.from_numpy(sin_np).to(device)
    c2, s2 = ak.rotary_roll_tables(cos, sin)
    bias = torch.zeros((b, s), dtype=torch.float32, device=device)
    scale = 1.0 / math.sqrt(hd)

    def chain():
        x = qkv.view(b, s, 3, h, hd)
        q = apply_rotary(x[:, :, 0], cos, sin)
        k = apply_rotary(x[:, :, 1], cos, sin)
        logits = torch.einsum("bshd,bthd->bhst", q, k) * torch.tensor(
            scale, dtype=torch.bfloat16)
        logits = logits + bias[:, None, None, :].to(torch.bfloat16)
        probs = torch.softmax(logits.float(), dim=-1).to(torch.bfloat16)
        ctx = torch.einsum("bhst,bthd->bshd", probs, x[:, :, 2])
        return ctx.reshape(b, s, h * hd)

    def fused_qkv():
        return ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)

    def fused_hm():
        x = qkv.view(b, s, 3, h, hd)
        q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        ctx = ak.fused_attention(q, k, v, c2, s2, bias, scale)
        return ctx.transpose(1, 2).reshape(b, s, h * hd)

    cases = {"chain": chain, "fused_qkv": fused_qkv, "fused_hm": fused_hm}
    outs = {name: fn().float() for name, fn in cases.items()}
    ref = outs["chain"]
    ok = True
    for name in ("fused_qkv", "fused_hm"):
        o = outs[name]
        cos_sim = float((ref * o).sum() / (ref.norm() * o.norm()))
        ok &= cos_sim >= MIN_COS and bool(torch.isfinite(o).all())
        print(f"cos({name}, chain) = {cos_sim:.7f} (bound {MIN_COS})",
              flush=True)
    same = torch.equal(outs["fused_qkv"], outs["fused_hm"])
    print(f"K7 head-major == K8 on the Wqkv layout, bit for bit: {same}",
          flush=True)
    ok &= same
    del outs, ref

    ak.reset_launch_counts()
    best = {name: math.inf for name in cases}
    for rnd in range(ROUNDS):
        for name, fn in cases.items():
            def run(fn=fn):
                for _ in range(ITERS):
                    fn()
            best[name] = min(best[name], 1e3 * _device_seconds(device, run)
                             / ITERS)
        print(f"round {rnd}: " + " | ".join(f"{n}: {t:.3f} ms"
                                             for n, t in best.items()),
              flush=True)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    for name, t in best.items():
        print(f"{name:>10s}: {t:8.3f} ms/layer [{b} x {h} x {s} x {hd}, "
              f"{where}]", flush=True)
    print(json.dumps({"ms": best}), flush=True)
    print("launches " + json.dumps({k: ak.launch_counts[k] for k in (
        "fused_attention", "fused_attention_qkv")}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
