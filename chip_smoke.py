"""Smoke run of the PyTorch port's exact search path on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Builds the CUDA kernels from ``better_search_rag_rust_tpu_torch/ops/csrc``,
then, at the main path's shapes (a 1M x 768 store, nomic-embed-text-v1.5's
width, queried 512 at a time, top-100):

1. device: card name and power limit; kernel build time;
2. each kernel (K1 matmul_blockmax2_only, K2 gather_rescore, K3
   matmul_blockmax) against its plain PyTorch version, max |diff| <= 1e-5
   (the plain versions sum in cuBLAS's order, not the kernels');
3. the kernels against each other, bit for bit (one FMA chain per score);
4. the main path — Pipeline.engine + evaluate (1024 queries, k=100: MRR,
   recall@k and oracle overlap must be 1.0) + three search_stream batches —
   on a 1M x 768 bf16 store (route rescore: K1 + K2), a 100k x 768 bf16
   store (route global: K3) and a 1M x 768 f32 store (route rescore),
   with every kernel's launch count over that run;
5. timings: queries/sec of search and search_device on the 1M bf16 store,
   and each kernel's time beside its plain version's.

Prints one line per phase, then the card line, the kernels JSON line and,
last, ``{"ok": true, "device": ...}``. Any failed check raises: the exit
code is non-zero and the last line is not printed. Stores are seeded
(``--seed``); nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

K = 100
T = 512
SUB, BLOCK = 64, 128
TOL = 1e-5
SOURCE = "better_search_rag_rust_tpu_torch/ops/csrc/topk_kernels.cu"
REPLACES = {
    "matmul_blockmax2_only": "better_search_rag_rust_tpu/ops/topk_pallas.py:527",
    "gather_rescore": "better_search_rag_rust_tpu/ops/topk_pallas.py:656",
    "matmul_blockmax": "better_search_rag_rust_tpu/ops/topk_pallas.py:120",
}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def phase(msg: str) -> None:
    print(msg, flush=True)


def check_kernels(store, store_100k, gen):
    """Phases 2 and 3: kernels against plain versions and each other."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    data, n = store.data, store.num_rows
    rows = torch.randint(0, n, (T,), generator=gen, device="cuda")
    q = data[rows].contiguous()
    errs, times = {}, {}

    def k1():
        return tk.matmul_blockmax2_only(q, data, n, sub=SUB, block=BLOCK,
                                        emit_block=True, emit_argmax=True)

    def k1_plain():
        return tk.matmul_blockmax2_only_plain(
            q, data, n, sub=SUB, block=BLOCK, emit_block=True,
            emit_argmax=True)

    bms, key, bm = k1()
    p_bms, p_key, p_bm = k1_plain()
    torch.cuda.synchronize()
    top2 = (q.float() @ data.float().T).T.reshape(-1, SUB, T).topk(2, dim=1)
    gap = top2.values[:, 0] - top2.values[:, 1]
    clear = gap > TOL
    arg_ok = torch.equal((key & 0x7F)[clear], (p_key & 0x7F)[clear])
    errs["matmul_blockmax2_only"] = max(max_abs(bms, p_bms), max_abs(bm, p_bm))
    phase(f"phase 2 K1 [{T} x {data.shape[0]} x {data.shape[1]}] sub={SUB}: "
          f"max|bm_sub-plain|={max_abs(bms, p_bms):.3g} "
          f"max|bm-plain|={max_abs(bm, p_bm):.3g} argmax equal on "
          f"{int(clear.sum())}/{clear.numel()} resolved units: {arg_ok}")
    assert errs["matmul_blockmax2_only"] <= TOL and arg_ok
    times["matmul_blockmax2_only"] = (cuda_ms(k1), cuda_ms(k1_plain))
    del top2, gap, clear, p_bms, p_key, p_bm

    n_units = data.shape[0] // SUB
    errs["gather_rescore"] = 0.0
    for ks in (4, 100):
        ids = torch.sort(torch.randint(0, n_units, (T, ks), generator=gen,
                                       device="cuda"), dim=1).values
        ids = ids.to(torch.int32).contiguous()
        out = tk.gather_rescore(q, data, ids, unit=SUB)
        ref = tk.gather_rescore_plain(q, data, ids, unit=SUB)
        err = max_abs(out, ref)
        errs["gather_rescore"] = max(errs["gather_rescore"], err)
        ms = cuda_ms(lambda: tk.gather_rescore(q, data, ids, unit=SUB))
        pms = cuda_ms(lambda: tk.gather_rescore_plain(q, data, ids, unit=SUB))
        times[f"gather_rescore_ks{ks}"] = (ms, pms)
        phase(f"phase 2 K2 KS={ks} unit={SUB}: max|out-plain|={err:.3g}")
        assert err <= TOL
    times["gather_rescore"] = times["gather_rescore_ks100"]

    # the dense route scores 256 queries per K3 launch (ops/engine.py)
    q100 = store_100k.data[rows[:256] % store_100k.num_rows].contiguous()
    sims, bm_t = tk.matmul_blockmax(q100, store_100k.data,
                                    store_100k.num_rows)
    p_sims, p_bm_t = tk.matmul_blockmax_plain(q100, store_100k.data,
                                              store_100k.num_rows)
    errs["matmul_blockmax"] = max(max_abs(sims, p_sims), max_abs(bm_t, p_bm_t))
    phase(f"phase 2 K3 [256 x {store_100k.data.shape[0]} x 768]: "
          f"max|sims-plain|={max_abs(sims, p_sims):.3g} "
          f"max|bm-plain|={max_abs(bm_t, p_bm_t):.3g}")
    assert errs["matmul_blockmax"] <= TOL
    times["matmul_blockmax"] = (
        cuda_ms(lambda: tk.matmul_blockmax(q100, store_100k.data,
                                           store_100k.num_rows)),
        cuda_ms(lambda: tk.matmul_blockmax_plain(q100, store_100k.data,
                                                 store_100k.num_rows)))
    del sims, bm_t, p_sims, p_bm_t

    # phase 3: K2 at each unit's argmax row == K1's unit max == K3's score,
    # on valid units (K1/K3 mask padding rows to PAD_SIM, K2 does not mask)
    units = torch.sort(torch.randint(0, n // SUB, (T, 256), generator=gen,
                                     device="cuda"), dim=1).values
    resc = tk.gather_rescore(q, data, units.to(torch.int32).contiguous(),
                             unit=SUB).view(T, 256, SUB)
    arg = torch.gather((key & 0x7F).T.to(torch.int64), 1, units)
    k2_at_arg = torch.gather(resc, 2, arg[:, :, None])[:, :, 0]
    k1_max = torch.gather(bms.T, 1, units)
    sims, _ = tk.matmul_blockmax(q, data, n)
    k3_at_arg = torch.gather(sims, 1, units * SUB + arg)
    same = torch.equal(k2_at_arg, k1_max) and torch.equal(k3_at_arg, k1_max)
    phase(f"phase 3 identity on {units.numel()} (query, unit argmax) pairs: "
          f"K1 == K2 == K3 bitwise: {same}")
    assert same
    return errs, times


def drive_main_path(name, store, cfg, gen, route):
    """Phase 4 on one store: engine, evaluate, three streamed batches."""
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline

    pipe = Pipeline(cfg, device="cuda")
    engine = pipe.engine(store)
    t0 = time.perf_counter()
    report = pipe.evaluate(num_queries=1024, k=K)
    eval_s = time.perf_counter() - t0
    assert engine.kernel_name(K) == route, engine.kernel_name(K)
    batches, truth = [], []
    for _ in range(3):
        rows = torch.randint(0, store.num_rows, (1024,), generator=gen,
                             device="cuda")
        batches.append(store.data[rows].float().cpu().numpy())
        truth.append(rows.cpu().numpy())
    streamed = list(engine.search_stream(batches, k=K, depth=2))
    self_hits = [float(np.mean(ids[:, 0] == t))
                 for (ids, _), t in zip(streamed, truth)]
    again, _ = engine.search(batches[0], K)
    phase(f"phase 4 {name}: route={engine.kernel_name(K)} "
          f"mrr={report['mrr']} recall@{K}={report['recall_at_k']} "
          f"oracle_overlap={report['oracle_overlap']} evaluate "
          f"{eval_s:.2f}s; 3 streamed batches self-hit@1={self_hits}")
    assert report["mrr"] == report["recall_at_k"] == 1.0
    assert report["oracle_overlap"] == 1.0
    assert self_hits == [1.0, 1.0, 1.0]
    assert np.array_equal(again, streamed[0][0])
    return engine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from better_search_rag_rust_tpu_torch.config import (
        PipelineConfig,
        SearchConfig,
    )
    from better_search_rag_rust_tpu_torch.ops import _build
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    lib = _build.library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    phase(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernel build {lib.build_s:.1f}s "
          f"({lib.path.name}); ptxas: {' / '.join(regs)}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    store = DeviceStore.synthetic(1_000_000, 768, "bfloat16", args.seed,
                                  device="cuda")
    store_100k = DeviceStore.synthetic(100_000, 768, "bfloat16",
                                       args.seed + 1, device="cuda")
    errs, times = check_kernels(store, store_100k, gen)

    cfg = PipelineConfig(search=SearchConfig(top_k=K), skip_process=True)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    engine = drive_main_path("1M x 768 bf16", store, cfg, gen, "rescore")
    drive_main_path("100k x 768 bf16", store_100k, cfg, gen, "global")
    store_f32 = DeviceStore.synthetic(1_000_000, 768, "float32",
                                      args.seed + 2, device="cuda")
    drive_main_path("1M x 768 f32", store_f32, cfg, gen, "rescore")
    torch.cuda.synchronize()
    launches = dict(tk.launch_counts)
    phase(f"phase 4 kernel launches over the main path: {launches}")
    assert all(v > 0 for v in launches.values()), launches
    del store_f32

    rows = torch.randint(0, store.num_rows, (1024,), generator=gen,
                         device="cuda")
    queries = store.data[rows].float().cpu().numpy()
    engine.search(queries, K)  # warm-up
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.search(queries, K)
    host_qps = 1024 * iters / (time.perf_counter() - t0)
    qdev = engine.prepare_device_queries(queries)
    engine.search_device(qdev, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.search_device(qdev, K)
    torch.cuda.synchronize()
    dev_qps = 1024 * iters / (time.perf_counter() - t0)
    phase(f"phase 5 [{card}] 1M x 768 bf16, 1024 queries, k={K}: "
          f"search {host_qps:.1f} q/s, search_device {dev_qps:.1f} q/s")
    for name, (ms, pms) in times.items():
        phase(f"phase 5 [{card}] {name}: kernel {ms:.3f} ms, plain "
              f"{pms:.3f} ms")

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
