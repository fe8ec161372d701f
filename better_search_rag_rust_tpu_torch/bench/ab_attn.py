"""A/B of builds of the attention kernels' source on the card, in one process.

    python -m better_search_rag_rust_tpu_torch.bench.ab_attn OLD.cu NEW.cu [...]

Each argument is a copy of ``ops/csrc/attention_kernels.cu`` — the parent
commit's (unpack it with ``git archive`` into a git-ignored directory), the
tree's, or a copy with one edit — or the name of a variant that this module
writes from the tree's source into ``build/ab_attn/`` (:data:`VARIANTS`;
``@a+b`` applies both edits): ``@mma_sync``, K8/K7 on ``mma.sync`` as
shipped before the ``wgmma`` body (``attend_mma_sync.cuh`` spliced in place
of the forward block: the reference the new body is held to bit for bit);
``@stream``, K and V streamed through the four-stage TMA ring at every S,
a block per 128 query rows, each K tile rotated as it lands in each pass
(what the resident, once-rotated K and V buy); ``@kres``, a block a head,
K resident and rotated by all its threads before any product, V streamed
through the ring for each pair of query tiles, at every S (where the
persistent blocks run: what rotating the next head's K under the current
head's products buys); ``@fastexp``, ``__expf`` (ex2.approx) in place of
the accurate ``expf`` (its gain, and the float64 lines that decided
against it);
``@acc``, K8's QK^T k16 steps accumulated inside the ``wgmma``
(``ATT_QK_ADDS``) instead of each from +0.0 with one rounded add (what the
rounded add costs, and the error it saves); ``@nopass1``, pass 1 skipped
and e taken against 0, no key tile skipped (wrong answers: what the
exact max costs); ``@noskip``, pass 2 runs every key tile, those whose e
is all 0 too (what the skip buys); ``@ringonce``, the ring (hd 128 above S
512) rotates each K tile for pass 1 only (wrong answers: what the second
rotation costs);
``@bwdacc``, K9's dp, dv, dk and dq accumulated inside the ``wgmma``
instead of a rounded add per k16 step (``K9_STEP_ADDS``: its cost, and the
error it saves); ``@k9noadd``, every K9 product accumulated inside the
``wgmma``, QK^T too (``K9_QK_ADDS`` and ``K9_STEP_ADDS``: what the rule's
adds cost); ``@k9fastexp``, K9's ``expf`` taken as ``__expf``, and
``@k9fastdiv``, its p = e / l as e times 1/l (other answers: what the
accurate exponential and the exact division cost); ``@dump``, a debug build (``K9_DUMP``) whose K9
writes both kernels' p, dp and ds behind its scratch, compared bit for bit
(:func:`k9_dump_compare`; not timed). The K8/K7 variants leave K9 as it
is.
Every build uses the package's nvcc flags (:data:`.._build.NVCC_FLAGS`),
all started together, and is bound with the package's C signatures, so
every build must keep the entry points of the tree.

``--batch``, ``--seq``, ``--hd`` set K8/K7's shape (and K9's S and hd),
``--unpadded`` makes every key valid, ``--k8-only`` leaves K9 out.
``--lengths`` draws K8/K7's key lengths (:data:`LENGTHS`): ``uniform`` on
[1, S] with the last row fully padded (the default), or a corpus's token
counts (:func:`corpus_lengths`): ``java``, the tree that ``chip_smoke.py``'s
build mode ingests, or ``jabref``, the JabRef-like corpus of
``bench/jabref.py``. The run prints its batch's padded-key share and the
share of its 64-key tiles past a row's length (the tiles pass 2 skips).
``--shares`` prints those shares over each whole corpus and exits; it
needs no card.

Timed with CUDA events (:data:`ITERS` launches after a warm-up), every
build in turn and then in reverse order, so that a drift of the card shows
as a spread between the two passes rather than as a difference between
builds: K8 ``fused_attention_qkv`` and K7 ``fused_attention`` at the
encoder's shape (B 256, S 512, H 12, hd 64; random key lengths, one batch
row fully padded), K9 ``fused_attention_qkv_bwd`` at the finetune shape
(B 64), with K9's device time split over its three kernels (torch.profiler:
the rotary pre-pass, the query kernel, the key kernel). Every build gets
the tree's K9 scratch (:func:`..ops.attention_kernels.k9_scratch_floats`),
which holds an older build's ``[3, B, H, S]`` statistics at its start. Then, per build: K8's and K9's error against a float64 evaluation of the
same function with the same rounding points (rotary in f32 rounded to
bf16, f32 logits, the exact max, the denominator over the unrounded e, PV on bf16(e),
the division after PV): max and mean over valid query rows and the count
of cells off the float64 value rounded to bf16 (finer than the max and
mean, which the output's own rounding dominates), beside the plain
version's (K9: :func:`reference64_bwd`, every cell of dqkv); whether K7
on the transposed operands equals K8 bit for bit and two launches of K8,
and of K9, agree bit for bit; for a ``@dump`` build, whether K9's two
passes saw the same p, dp and ds; the ptxas report of the K8, K7 and
K9 bodies (registers, spills); the card's name and power limit. Needs a CUDA
card; ``chip_smoke.py`` holds each kernel to its plain version.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import attention_kernels as ak
from . import ab_topk
from .ab_topk import _edit, device_ms

OUT = _build.BUILD_DIR.parent / "ab_attn"
ITERS = 5
B, S, H, HD = 256, 512, 12, 64
B_BWD = 64
#: Every key valid (``--unpadded``): no key tile's e is 0 throughout.
UNPADDED = False
#: How K8/K7's key lengths are drawn (``--lengths``: ``uniform``, ``java``,
#: ``jabref``).
LENGTHS = "uniform"
#: The corpora's sizes for ``--shares``: ``chip_smoke.py``'s build-mode tree
#: (TREE_FILES) and the JabRef corpus (``jabref.JABREF_FILES``).
CORPUS_FILES = {"java": 4096, "jabref": 2305}
TREE_SOURCE = _build.SOURCES["attention"][0]


_PERSISTENT = "  if (att_smem_bytes<HD>(S, ATT_PERSISTENT) <= SMEM_OPTIN) return ATT_PERSISTENT;\n"
_KRES = "  if (att_smem_bytes<HD>(S, ATT_KRES) <= SMEM_OPTIN) return ATT_KRES;\n"
_RING_USED = "  constexpr bool ring = att_smem_bytes<HD>(MAX_S, ATT_KRES) > SMEM_OPTIN;"
_KRES_USED = "  constexpr bool kres = att_smem_bytes<HD>(MAX_S, ATT_PERSISTENT) > SMEM_OPTIN;"
#: Pass 2's skip of a key tile whose e is all 0.
_SKIP = """          if (!active || (!((need >> j) & 1u) && !(STREAM && v_tile_nonfinite<HD>(vt, 1 + cw)))) {
"""
#: The ring's rotation of each K tile as it lands (both passes' tiles).
_RING_ROTATE = "        rotate_tile<HD, 2>(ktile(0, st), (i % n) * WG_ROWS, S, cos2, s2, tid, 128);\n"
#: Pass 1's work on a tile (the first ``if (active)`` of ``attend``'s key
#: loops: the only one followed by the tile maxima's comment).
_PASS1 = """          if (active) {
            float s[32];
            s_tile<HD, NP, false>(s, qa, kt, o, pa, vt);
            const int k0 = j * WG_ROWS;
            float t0, t1;  // the tile's maxima"""

HERE = Path(__file__).resolve().parent


def _between(src: str, what: str, block: str) -> str:
    """``src`` with its ``what`` block (between ``// ==== what: begin`` and
    ``// ==== what: end ====``) replaced by ``block``."""
    begin, end = f"// ==== {what}: begin", f"// ==== {what}: end ====\n"
    a = src.index(begin)
    b = src.index(end) + len(end)
    return src[:a] + block + src[b:]


def _mma_sync(src: str) -> str:
    """K8/K7 on ``mma.sync`` as shipped before the ``wgmma`` body:
    ``attend_mma_sync.cuh`` (device code and launchers) in place of the
    forward block, the tree's launchers dropped."""
    src = _between(src, "K8/K7 launchers", "")
    return _between(src, "K8/K7 forward", (HERE / "attend_mma_sync.cuh").read_text())


#: Variant name -> its source from the tree's source text (module
#: docstring).
VARIANTS = {
    "mma_sync": _mma_sync,
    "stream": lambda src: _edit(_edit(_edit(src, _PERSISTENT, ""), _KRES, ""),
                                _RING_USED, "  constexpr bool ring = true;"),
    "kres": lambda src: _edit(_edit(src, _PERSISTENT, ""), _KRES_USED,
                              "  constexpr bool kres = true;"),
    "fastexp": lambda src: src.replace("= expf(__fsub_rn(logit_of",
                                       "= __expf(__fsub_rn(logit_of"),
    "acc": lambda src: _edit(src, "constexpr bool ATT_QK_ADDS = true;",
                             "constexpr bool ATT_QK_ADDS = false;"),
    "nopass1": lambda src: _edit(_edit(
        src, "may be nonzero.\n        float m0 = -INFINITY, m1 = -INFINITY;",
        "may be nonzero.\n        float m0 = 0.f, m1 = 0.f;"),
        _PASS1, _PASS1.replace("if (active) {", "if (false) {", 1)).replace(
            "uint32_t need = 0u;", "uint32_t need = ~0u;"),
    "noskip": lambda src: _edit(src, _SKIP, "          if (!active) {\n"),
    "ringonce": lambda src: _edit(src, _RING_ROTATE, "        if (i < n)\n  " + _RING_ROTATE),
    "bwdacc": lambda src: _edit(src, "constexpr bool K9_STEP_ADDS = true;",
                                "constexpr bool K9_STEP_ADDS = false;"),
    "dump": lambda src: _edit(src, "#include <cuda_bf16.h>",
                              "#define K9_DUMP 1\n#include <cuda_bf16.h>"),
    "k9noadd": lambda src: _edit(_edit(
        src, "constexpr bool K9_QK_ADDS = true;", "constexpr bool K9_QK_ADDS = false;"),
        "constexpr bool K9_STEP_ADDS = true;", "constexpr bool K9_STEP_ADDS = false;"),
    "k9fastexp": lambda src: _edit(src, "  return expf(x);", "  return __expf(x);"),
    "k9fastdiv": lambda src: _edit(_edit(
        src, "  return __fmaf_rn(__fmaf_rn(-l, q0, e), y, q0);", "  return q0;"),
        "  return e == 0.f || (bits >= (27 << 23) && fabsf(r) < thr);", "  return true;"),
}


def source_path(arg: str) -> Path:
    """A source argument as a file: ``@a+b`` writes the tree's source with
    variants ``a`` and ``b`` applied into :data:`OUT`."""
    if not arg.startswith("@"):
        return Path(arg)
    OUT.mkdir(parents=True, exist_ok=True)
    src = TREE_SOURCE.read_text()
    for name in arg[1:].split("+"):
        src = VARIANTS[name](src)
    path = OUT / f"{arg[1:].replace('+', '_')}.cu"
    path.write_text(src)
    return path


def build(paths):
    """``{name: (ctypes library, ptxas lines of the K8, K7 and K9
    bodies)}``,
    one nvcc per source, all started together."""
    return ab_topk.build(paths, library="attention", out=OUT,
                         entry=lambda line: "k8_fused" in line
                         or "k7_fused" in line or "k9_" in line)


def corpus_lengths(kind, files, seq, seed=0):
    """The token count (the mask's length) of each of the first ``files``
    files of corpus ``kind``, in name order, through the port's hashing
    tokenizer at ``seq`` tokens (the nomic backend's without a checkpoint):
    ``java``, :func:`.suite.write_java_tree`'s tree (400 words a file);
    ``jabref``, :func:`.jabref.synthesize_jabref_corpus`'s. Written into a
    temporary directory and removed; host work only."""
    from ..models.tokenizer import HashingTokenizer

    with tempfile.TemporaryDirectory(prefix="bsr_ab_attn_") as tmp:
        root = Path(tmp) / "src"
        if kind == "java":
            from .suite import write_java_tree

            write_java_tree(str(root), files, seed)
        else:
            from .jabref import synthesize_jabref_corpus

            synthesize_jabref_corpus(root, files, seed)
        texts = [p.read_text() for p in sorted(root.rglob("*.java"))]
    tok = HashingTokenizer(max_tokens=seq)
    return np.concatenate([tok.encode_batch(texts[i:i + 256])[1].sum(axis=1)
                           for i in range(0, len(texts), 256)])


def pad_shares(lens, seq):
    """The padded keys' share of rows of ``lens`` keys at ``seq``, and the
    share of their 64-key tiles wholly past a row's length (those pass 2
    skips; a fully padded row's tiles all run)."""
    lens = np.asarray(lens, dtype=np.float64)
    tiles = -(-seq // 64)
    run = np.where(lens == 0, tiles, np.ceil(lens / 64))
    return 1 - lens.mean() / seq, 1 - run.mean() / tiles


def operands(b, seed):
    """qkv [b, S, 3 H HD] bf16, the rotary tables, the key bias (random
    lengths, the last row fully padded; :data:`LENGTHS` a corpus: its first
    b files' token counts; :data:`UNPADDED`: every key valid), the
    valid-key mask and the scale."""
    from ..models.nomic import rotary_tables

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qkv = torch.randn((b, S, 3 * H * HD), generator=gen, device=dev)
    lens = torch.randint(1, S + 1, (b,), generator=gen, device=dev)
    lens[-1] = 0
    if LENGTHS != "uniform":
        lens = torch.from_numpy(corpus_lengths(LENGTHS, b, S, seed)).to(dev)
    if UNPADDED:
        lens.fill_(S)
    valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32).contiguous()
    cos, sin = (torch.from_numpy(t).to(dev) for t in rotary_tables(S, HD, 1000.0))
    c2, s2 = ak.rotary_roll_tables(cos, sin)
    return (qkv.to(torch.bfloat16), c2.contiguous(), s2.contiguous(), bias,
            valid, 1.0 / math.sqrt(HD))


def reference64(qkv, c2, s2, bias, heads, scale, chunk=16):
    """K8's function in float64 with its rounding points: the rotary in f32
    rounded to qkv's dtype, the dot in float64 and the logit in f32
    (``dot * scale + bias``, each step rounded, so a fully padded row's
    logits tie as the kernel's do), the exact max, e = exp(l - m), the
    denominator over the unrounded e, PV on e rounded to qkv's dtype, the
    division after PV. Returns the context [B, S, H*hd] in float64."""
    b, s, width = qkv.shape
    hd = width // (3 * heads)
    dt = qkv.dtype
    x = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)

    def rot(t):
        tf = t.to(torch.float32)
        return (tf * c2 + torch.roll(tf, hd // 2, dims=-1) * s2).to(dt)

    out = torch.empty((b, s, heads * hd), dtype=torch.float64, device=qkv.device)
    for b0 in range(0, b, chunk):
        sl = slice(b0, b0 + chunk)
        qr, kr = rot(x[0, sl]).double(), rot(x[1, sl]).double()
        v = x[2, sl].double()
        dots = (qr @ kr.transpose(-1, -2)).to(torch.float32)
        logits = (dots * scale + bias[sl, None, None, :]).double()
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        ctx = (e.to(dt).double() @ v) / e.sum(dim=-1, keepdim=True)
        out[sl] = ctx.permute(0, 2, 1, 3).reshape(-1, s, heads * hd)
    return out


def reference64_bwd(qkv, c2, s2, bias, g, heads, scale, chunk=4):
    """K9's function in float64 with the JAX kernel's rounding points
    (``attention_pallas.py:214-281``): the rotary in f32 rounded to qkv's
    dtype, the logit in f32 (the dot in float64 rounded to f32, then ``*
    scale + bias``), then in float64 p = e / sum(e), dv = round(p)^T g, dp
    = g v^T, row = sum(dp p), ds = round(p (dp - row) scale), dq_r = ds k_r,
    dk_r = ds^T q_r and the rotary adjoint, with round() to qkv's dtype.
    Returns dqkv [B, S, 3*H*hd] in float64, unrounded."""
    b, s, width = qkv.shape
    hd = width // (3 * heads)
    dt = qkv.dtype
    x = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    gh = g.to(dt).view(b, s, heads, hd).permute(0, 2, 1, 3)
    c64, s64 = c2.double(), s2.double()

    def rot(t):
        tf = t.to(torch.float32)
        return (tf * c2 + torch.roll(tf, hd // 2, dims=-1) * s2).to(dt)

    def adjoint(t):
        return t * c64 + torch.roll(t * s64, hd // 2, dims=-1)

    out = torch.empty((b, s, 3, heads, hd), dtype=torch.float64,
                      device=qkv.device)
    for b0 in range(0, b, chunk):
        sl = slice(b0, b0 + chunk)
        qr, kr = rot(x[0, sl]).double(), rot(x[1, sl]).double()
        v, gg = x[2, sl].double(), gh[sl].double()
        dots = (qr @ kr.transpose(-1, -2)).to(torch.float32)
        logits = (dots * scale + bias[sl, None, None, :]).double()
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        dv = p.to(dt).double().transpose(-1, -2) @ gg
        dp = gg @ v.transpose(-1, -2)
        row = (dp * p).sum(dim=-1, keepdim=True)
        ds = (p * (dp - row) * scale).to(dt).double()
        grads = (adjoint(ds @ kr), adjoint(ds.transpose(-1, -2) @ qr), dv)
        out[sl] = torch.stack(grads, dim=1).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, width)


def bwd_error(out, ref):
    """``out`` (bf16 dqkv) against the float64 ``ref`` over every cell: max
    and mean |error| and the cells off the float64 value rounded to bf16."""
    err = (out.double() - ref).abs()
    off = int((out != ref.to(torch.bfloat16)).sum())
    return (f"max {float(err.max()):.4g}, mean {float(err.mean()):.6g}, "
            f"{off} of {out.numel()} cells off the float64 value rounded to "
            f"bf16")


def k9_dump_compare(lib, qkv, c2, s2, bias, g, heads, scale):
    """Run a ``@dump`` build's K9 (``lib``) once and hold its two passes'
    p, dp and ds against each other bit for bit: ``{"p": bool, "dp": bool,
    "ds": bool, "cells": n, "written": bool}`` (``written``: both passes
    wrote every (query, key) cell of every head)."""
    b, s, width = qkv.shape
    hd = width // (3 * heads)
    head = ak.k9_scratch_floats(b, heads, s, hd)
    scratch = torch.full((head + 6 * b * heads * s * s,), float("nan"),
                         dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    if lib.bsr_fused_attention_qkv_bwd(
            qkv.data_ptr(), c2.data_ptr(), s2.data_ptr(), bias.data_ptr(),
            g.data_ptr(), b, s, heads, hd, scale, scratch.data_ptr(),
            dqkv.data_ptr(), torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("a kernel launch failed")
    torch.cuda.synchronize()
    dump = scratch[head:].view(2, b * heads, 3, s, s)
    bits = dump.view(torch.int32)
    res = {name: bool(torch.equal(bits[0, :, c], bits[1, :, c]))
           for c, name in enumerate(("p", "dp", "ds"))}
    res["cells"] = b * heads * s * s
    res["written"] = not bool(torch.isnan(dump).any())
    return res


def cases(seed):
    """``{label: (fn(lib) -> err, iters)}`` at the module docstring's
    shapes, and K8's operands for the error lines."""
    qkv, c2, s2, bias, valid, scale = operands(B, seed)
    q, k, v = (t.contiguous() for t in
               qkv.view(B, S, 3, H, HD).permute(2, 0, 3, 1, 4))
    out8 = torch.empty((B, S, H * HD), dtype=torch.bfloat16, device="cuda")
    out7 = torch.empty_like(q)
    gq, gc2, gs2, gbias, _, _ = operands(B_BWD, seed + 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    g = torch.randn((B_BWD, S, H * HD), generator=gen,
                    device="cuda").to(torch.bfloat16)
    dqkv = torch.empty_like(gq)
    stats = torch.empty((ak.k9_scratch_floats(B_BWD, H, S, HD),),
                        dtype=torch.float32, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    work = {
        f"K8 [{B} x {S} x {H} x {HD}]": (lambda lib: lib.bsr_fused_attention_qkv(
            qkv.data_ptr(), c2.data_ptr(), s2.data_ptr(), bias.data_ptr(), B, S,
            H, HD, scale, out8.data_ptr(), stream()), ITERS),
        f"K7 [{B} x {H} x {S} x {HD}]": (lambda lib: lib.bsr_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), c2.data_ptr(),
            s2.data_ptr(), bias.data_ptr(), B, S, H, HD, scale,
            out7.data_ptr(), stream()), ITERS),
        f"K9 [{B_BWD} x {S} x {H} x {HD}]": (
            lambda lib: lib.bsr_fused_attention_qkv_bwd(
                gq.data_ptr(), gc2.data_ptr(), gs2.data_ptr(), gbias.data_ptr(),
                g.data_ptr(), B_BWD, S, H, HD, scale, stats.data_ptr(),
                dqkv.data_ptr(), stream()), ITERS),
    }
    return work, (qkv, c2, s2, bias, valid, scale, q, k, v,
                  (gq, gc2, gs2, gbias, g))


def error_lines(libs, operands_, k9=True):
    """Per build: K8's error against :func:`reference64` (max and mean on
    valid query rows) beside the plain version's, K7 = K8, run-to-run
    equality and K8 against the first build's, bit for bit."""
    qkv, c2, s2, bias, valid, scale, q, k, v, bwd = operands_
    ref = reference64(qkv, c2, s2, bias, H, scale)[valid]
    ref_bf16 = ref.to(torch.bfloat16)
    plain = ak.fused_attention_qkv_plain(qkv, c2, s2, bias, H, scale)

    def stats(out):
        got = out[valid]
        err = (got.double() - ref).abs()
        off = int((got != ref_bf16).sum())
        return (f"max {float(err.max()):.4g}, mean {float(err.mean()):.6g}, "
                f"{off} of {got.numel()} cells off the float64 value rounded "
                f"to bf16")

    stream = torch.cuda.current_stream().cuda_stream
    lines = [f"plain K8 vs float64: {stats(plain)}"]
    first = None  # the first build's K8 output and name
    for name, (lib, _report) in libs.items():
        outs = []
        for _ in range(2):
            o = torch.empty((B, S, H * HD), dtype=torch.bfloat16, device="cuda")
            if lib.bsr_fused_attention_qkv(qkv.data_ptr(), c2.data_ptr(),
                                           s2.data_ptr(), bias.data_ptr(), B, S,
                                           H, HD, scale, o.data_ptr(), stream):
                raise RuntimeError("a kernel launch failed")
            outs.append(o)
        o7 = torch.empty_like(q)
        if lib.bsr_fused_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   c2.data_ptr(), s2.data_ptr(), bias.data_ptr(),
                                   B, S, H, HD, scale, o7.data_ptr(), stream):
            raise RuntimeError("a kernel launch failed")
        torch.cuda.synchronize()
        k7 = torch.equal(o7.permute(0, 2, 1, 3).reshape(B, S, H * HD), outs[0])
        first = first or (outs[0], name)
        lines.append(
            f"K8 vs float64, {name}: {stats(outs[0])}; max|k - plain| "
            f"{float((outs[0].float() - plain.float())[valid].abs().max()):.4g};"
            f" two launches bitwise {torch.equal(outs[0], outs[1])}; K7 = K8 "
            f"bitwise {k7}; bitwise {first[1]}'s K8 "
            f"{torch.equal(outs[0], first[0])}")
    del plain, ref, ref_bf16
    torch.cuda.empty_cache()
    if k9:
        lines += k9_error_lines(libs, bwd, scale)
    return lines


def k9_error_lines(libs, bwd, scale):
    """Per build: K9 at B_BWD against :func:`reference64_bwd` beside the
    plain version, two launches bit for bit."""
    gq, gc2, gs2, gbias, g = bwd
    ref = reference64_bwd(gq, gc2, gs2, gbias, g, H, scale)
    plain = ak.fused_attention_qkv_bwd_plain(gq, gc2, gs2, gbias, g, H, scale)
    lines = [f"plain K9 vs float64: {bwd_error(plain, ref)}"]
    del plain
    torch.cuda.empty_cache()
    stream = torch.cuda.current_stream().cuda_stream
    stats = torch.empty((ak.k9_scratch_floats(B_BWD, H, S, HD),),
                        dtype=torch.float32, device="cuda")
    for name, (lib, _report) in libs.items():
        outs = []
        for _ in range(2):
            o = torch.empty_like(gq)
            if lib.bsr_fused_attention_qkv_bwd(
                    gq.data_ptr(), gc2.data_ptr(), gs2.data_ptr(),
                    gbias.data_ptr(), g.data_ptr(), B_BWD, S, H, HD, scale,
                    stats.data_ptr(), o.data_ptr(), stream):
                raise RuntimeError("a kernel launch failed")
            outs.append(o)
        torch.cuda.synchronize()
        lines.append(f"K9 vs float64, {name}: {bwd_error(outs[0], ref)}; "
                     f"two launches bitwise {torch.equal(outs[0], outs[1])}")
    return lines


def k9_dump_line(name, lib, bwd, scale):
    """A ``@dump`` build's line: its two passes' p, dp and ds bit for bit
    (:func:`k9_dump_compare`) on the first two batch rows of K9's operands.
    Such a build writes behind the statistics, so it is never launched with
    the ordinary scratch: it is neither timed nor held to float64."""
    gq, gc2, gs2, gbias, g = bwd
    res = k9_dump_compare(lib, gq[:2], gc2, gs2, gbias[:2], g[:2], H, scale)
    return (f"K9 passes bitwise, {name}, over {res['cells']} cells: p "
            f"{res['p']}, dp {res['dp']}, ds {res['ds']}, every cell written "
            f"{res['written']}")


def k9_split(fn, iters=3):
    """Device ms per launch of K9's three kernels under ``fn`` (one K9
    launch), by torch.profiler: ``{"rotate": ms, "query": ms, "key": ms}``
    (the tree's kernel names and the mma.sync build's)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {"k9_rotate_": "rotate", "k9_wg_query": "query",
             "k9_bwd_query": "query", "k9_wg_key": "key", "k9_bwd_key": "key"}
    split = dict.fromkeys(names.values(), 0.0)
    for ev in prof.key_averages():
        for kernel, part in names.items():
            if kernel in ev.key:
                split[part] += ev.device_time_total / 1000 / iters
    return split


def main(argv=None) -> int:
    global B, S, HD, UNPADDED, LENGTHS
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="copies of attention_kernels.cu, or @variant names")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=B, help="K8/K7's batch rows")
    ap.add_argument("--seq", type=int, default=S, help="S of every kernel")
    ap.add_argument("--hd", type=int, default=HD, help="head width of every kernel")
    ap.add_argument("--unpadded", action="store_true", help="every key valid")
    ap.add_argument("--k8-only", action="store_true",
                    help="time and check K8/K7 alone (no K9)")
    ap.add_argument("--lengths", choices=("uniform", "java", "jabref"),
                    default=LENGTHS, help="how K8/K7's key lengths are drawn")
    ap.add_argument("--shares", action="store_true",
                    help="print each corpus's padded shares and exit")
    args = ap.parse_args(argv)
    if args.shares:
        for kind, files in CORPUS_FILES.items():
            lens = corpus_lengths(kind, files, args.seq, args.seed)
            keys, tiles = pad_shares(lens, args.seq)
            print(f"{kind}, {files} files at S {args.seq}: mean length "
                  f"{lens.mean():.2f}, {int((lens == args.seq).sum())} rows "
                  f"full; padded keys {100 * keys:.2f} %, key tiles past a "
                  f"row's length {100 * tiles:.2f} %")
        return 0
    if not args.sources:
        ap.error("the sources are required")
    if not torch.cuda.is_available():
        raise SystemExit("ab_attn: no CUDA device")
    B, S, HD, UNPADDED = args.batch, args.seq, args.hd, args.unpadded
    LENGTHS = args.lengths
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build([source_path(s) for s in args.sources])
    timed = {name: v for name, v in libs.items() if "dump" not in name}
    work, ops = cases(args.seed)
    keys, tiles = pad_shares(ops[4].sum(dim=1).cpu().numpy(), S)
    print(f"K8/K7 key lengths {'all S' if UNPADDED else LENGTHS}: padded keys "
          f"{100 * keys:.2f} %, key tiles past a row's length "
          f"{100 * tiles:.2f} %", flush=True)
    if args.k8_only:
        work = {label: v for label, v in work.items() if not label.startswith("K9")}
    times = {label: {name: [] for name in timed} for label in work}
    for name in list(timed) + list(timed)[::-1]:
        lib = timed[name][0]
        for label, (fn, iters) in work.items():
            times[label][name].append(device_ms(lambda: fn(lib), iters))
    for label, by_build in times.items():
        print(f"{label}: " + "; ".join(
            f"{name} {' / '.join(f'{ms:.4f}' for ms in v)} ms"
            for name, v in by_build.items()), flush=True)
    k9 = next((label for label in work if label.startswith("K9")), None)
    for name, (lib, _report) in (timed.items() if k9 else ()):
        split = k9_split(lambda: work[k9][0](lib))
        print(f"{k9} split, {name}: " + ", ".join(
            f"{part} {ms:.4f} ms" for part, ms in split.items()), flush=True)
    for line in error_lines(timed, ops, k9=k9 is not None):
        print(line, flush=True)
    for name, (lib, _report) in libs.items():
        if "dump" in name:
            print(k9_dump_line(name, lib, ops[-1], ops[5]), flush=True)
    for name, (_lib, report) in libs.items():
        print(f"ptxas {name}: " + " | ".join(report))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
