"""Where a ``train svs`` step of the PyTorch port spends its time on a CUDA
card, float32 against bf16.

Runs the port's ``train svs`` (its CLI, in this process) twice at
``chip_smoke.py``'s training cell (B=16 x T=1536 frames, the base config's
encoder and 20 x 256 WaveNet, synthetic data), once with ``bf16: false``
and once with ``bf16: true``, each with the trainer's ``profile_steps``
(``torch.profiler`` from the session's step 10). From each chrome trace it
prints one JSON line: the profiled steps' wall time (profiler overhead
included), the card's busy time and idle share, the kernel time by group
(the port's own kernels from ``csrc/``, GEMMs, casts and copies,
multi-tensor ops, the rest), the ten costliest kernels and the ten
costliest host ops.

    python3 tools/profile_torch_train.py [--steps 3] [--out build/profile_train]

Needs a CUDA card; the traces are kept under ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GEMM = re.compile(r"gemm|gemv|cutlass|xmma|sm90_|sm80_|cublas", re.I)


def csrc_kernels() -> set:
    """The names of the port's hand-written kernels (``__global__`` in
    ``prodiff_tpu_torch/csrc``)."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "prodiff_tpu_torch", "csrc", "*.cu*")):
        with open(path) as f:
            parts = f.read().split("__global__")[1:]
        for text in parts:
            text = re.sub(r"^\s*void\s+", "", text)
            if text.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                for i in range(i, len(text)):
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    if depth == 0:
                        break
                text = text[i + 1:]
            found = re.match(r"\s*(?:void\s+)?(\w+)\s*\(", text)
            if found:
                names.add(found.group(1))
    return names


def group(name: str, own: set) -> str:
    """``csrc`` (the port's kernels), ``gemm``, ``copy`` (dtype casts and
    copies), ``foreach`` (multi-tensor ops: the optimizer) or ``other`` for a
    kernel
    name as the trace gives it (``(anonymous
    namespace)::save_gate_kernel(float const*, ...)``, ``void
    cutlass::Kernel2<...>(...)``)."""
    name_only = name.replace("(anonymous namespace)::", "").replace("void ", "")
    base = re.split(r"[<(]", name_only, maxsplit=1)[0].split("::")[-1].strip()
    if base in own:
        return "csrc"
    if GEMM.search(name):
        return "gemm"
    if "copy_kernel" in name:
        return "copy"
    return "foreach" if "multi_tensor_apply" in name else "other"


def busy_us(spans) -> float:
    """The union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarise(trace_path: str, steps: int, own: set) -> dict:
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    host = [e for e in events if e.get("cat") == "cpu_op"]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    by_group, by_name, by_op = defaultdict(float), defaultdict(float), defaultdict(float)
    for e in kernels:
        by_group[group(e["name"], own)] += e["dur"]
        by_name[e["name"][:90]] += e["dur"]
    for e in host:
        by_op[e["name"]] += e["dur"]
    busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)

    def ms_per_step(us):
        return us / steps / 1e3

    def top(d):
        return [[k, ms_per_step(v)] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"wall_ms_per_step": ms_per_step(t1 - t0), "busy_ms_per_step": ms_per_step(busy),
            "idle_share": 1.0 - busy / (t1 - t0), "kernels_per_step": len(kernels) / steps,
            "kernel_ms_per_step": {k: ms_per_step(v) for k, v in sorted(by_group.items())},
            "top_kernels_ms": top(by_name), "top_host_ops_ms": top(by_op)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="profiled steps per run")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_train"))
    args = ap.parse_args()
    import torch
    import yaml

    import chip_smoke
    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.training.trainer import PROFILE_AT
    from prodiff_tpu_torch.utils.synthetic import make_svs_dataset

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA card", file=sys.stderr)
        return 1
    out = os.path.abspath(args.out)
    data_dir = os.path.join(out, "data")
    make_svs_dataset(data_dir, n_train=2 * chip_smoke.TRAIN_B, n_valid=1, n_mels=128,
                     seed=7, t_ph_range=(32, 33), dur_range=(45, 49))
    hp = dict(chip_smoke.train_config(data_dir), val_check_interval=10 ** 6,
              num_sanity_val_steps=0, print_nan_grads=False, profile_steps=args.steps)
    own = csrc_kernels()
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    os.chdir(out)  # the runs' checkpoints/<exp_name> go here
    for label, bf16 in (("f32", False), ("bf16", True)):
        cfg = os.path.join(out, f"{label}.yaml")
        with open(cfg, "w") as f:
            yaml.dump(dict(hp, bf16=bf16), f)
        port_cli(["train", "svs", "--config", cfg, "--exp_name", label,
                  "--max_steps", str(PROFILE_AT + args.steps)])
        trace = sorted(glob.glob(os.path.join(out, "**", "profile", "trace_steps_*.json"),
                                 recursive=True), key=os.path.getmtime)[-1]
        print(json.dumps({"run": label, "card": name, "trace": os.path.relpath(trace, ROOT),
                          **summarise(trace, args.steps, own)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
