#!/usr/bin/env python
"""Headline benchmark of the PyTorch port on one CUDA card — prints ONE
JSON line.

    python3 bench_torch.py                      # the battery (default)
    BENCH_SUITE=search_100k python3 bench_torch.py
    python3 bench_torch.py --device cpu         # on the CPU (small suites)

The port's counterpart of ``bench.py``: ``BENCH_SUITE`` names one suite of
``better_search_rag_rust_tpu_torch/bench/suite.py`` (default ``battery``,
whose headline keys are ``search_1m``'s). For the battery the full result
goes to ``BSR_BENCH_DETAIL`` (default ``build/bench_detail_torch.json``) and
stdout gets the compact line (``compact_battery_summary``, at most 1.5 kB).
The exit code is 1 when any suite of the run failed (its entry carries an
``error``), after the line is printed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    suite = os.environ.get("BENCH_SUITE", "battery")
    from better_search_rag_rust_tpu_torch.bench.suite import (
        battery_errors,
        compact_battery_summary,
        run_suite,
    )

    result = run_suite(suite, device=args.device)
    errors = battery_errors(result)
    if "battery" in result:
        detail = os.environ.get(
            "BSR_BENCH_DETAIL",
            os.path.join(ROOT, "build", "bench_detail_torch.json"))
        os.makedirs(os.path.dirname(os.path.abspath(detail)), exist_ok=True)
        with open(detail, "w") as f:
            json.dump(result, f, indent=1)
        print(f"full battery detail -> {detail}", file=sys.stderr)
        result = compact_battery_summary(result)
    print(json.dumps(result), flush=True)
    if errors:
        print(f"failed suites: {errors}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
