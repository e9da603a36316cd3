"""Readings that set a cell's comparison limits, on the card at the cell's
own size: the program's numbers on many seeds and the control's (the
reference in TF32, the step below the float32 the configurations state) on
some, in one process, each seed with a short window at the cell's load.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --control 1,2,3 --seconds 3

With ``--fault <name>`` (one of the ``FAULTS`` of the cell's driver,
``drivers/<driver>.py``) the fault is planted in the program's set-up and
window on every seed.

Prints one JSON line a seed: {"seed", "fault", "program": {...}, "control": {...}}."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="", help="a fault of the driver's FAULTS, in every run")
    args = ap.parse_args(argv)
    os.environ["PRODIFF_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "cuda")
    sys.path[:0] = [HERE, ROOT]
    import torch

    import contextlib

    import harness

    if not torch.cuda.is_available():
        raise SystemExit("control readings need the CUDA card")
    cell, config, mix, limits = harness.load_cell(harness.load_benchmark(ROOT), args.workload)
    module = harness.driver_module(mix["driver"])
    faults = {f.__name__: f for f in module.FAULTS}
    control = {int(s) for s in args.control.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        d = module.DRIVER(config, mix, seed, harness.devices(cell), limits)
        with faults[args.fault]() if args.fault else contextlib.nullcontext():
            d.setup()
            d.window(args.seconds)
        d.release()
        line = {"seed": seed, "fault": args.fault or None,
                "program": {k: c["value"] for k, c in d.check().items()}}
        if seed in control:
            line["control"] = d.control()
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del d
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
