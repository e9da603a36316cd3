"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``benchmark/configs/<config>.json``) and a traffic
mix (``benchmark/traffic/<mix>.json``, whose ``driver`` names
``benchmark/drivers/<driver>.py``, how it drives the program); the comparison limits are ``benchmark/limits/<cell>.json``
and each per-layer metric is read by ``benchmark/metrics/<metric>.py``.
A new cell, configuration, mix, driver or metric is new files and entries;
the driver is handed one CUDA device a chip the cell asks for.

A ``--trace 1`` run records at most ``harness.TRACE_SECONDS`` of window.

The last line on standard output is the result's JSON; the numbers that
decided ``correct`` are the last lines on standard error. Without the CUDA
cards the cell asks for, or with JAX or the JAX package loaded after the
window, the run prints no result and exits with 1."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "prodiff_tpu")


def fail(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, sub in (("PRODIFF_TORCH_BUILD_DIR", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[key] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [HERE, ROOT]
    import harness
    import torch

    bench = harness.load_benchmark(ROOT)
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              harness.devices(cell), T_START)
    loaded = harness.banned_modules(BANNED)
    if loaded:
        fail(f"modules of JAX or the JAX package were loaded: {', '.join(loaded)}; no result")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
