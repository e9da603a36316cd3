"""The harness: find a cell's files by name, run its driver, read its
metrics, and assemble the result line.

Files found by name (nothing else is edited to add one):
- ``configs/<config>.json``: the configuration as run (its ``file`` in
  ``BENCHMARK.json``);
- ``traffic/<mix>.json``: a mix's parameters, read by the one generator
  (``generate.py``), and its ``driver``;
- ``drivers/<driver>.py``: how a mix drives the program (``driver.py``);
- ``limits/<cell>.json``: the limit of each number the cell's check compares;
- ``metrics/<metric>.py``: ``read(run) -> float | None`` for one per-layer
  metric, where ``run`` has ``cell``, ``config``, ``mix``, ``record`` (the
  driver's record of the window), ``trace`` (``tracing.Trace``) and
  ``peak`` (the configuration's FLOP/s)."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
# a traced run's window: reading the profiler's record of a run_seconds window
# of training (about 6,200 device operations a step) takes minutes, and the
# profiler slows the host the more the longer it records
TRACE_SECONDS = 10.0


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@functools.lru_cache(maxsize=None)
def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return load_module("metrics", name).read


def driver_module(name: str):
    """``drivers/<name>.py``: its ``DRIVER`` class and its ``FAULTS``."""
    return load_module("drivers", name)


def devices(cell: dict, kind: str = "cuda") -> list:
    """One device a chip the cell asks for (``kind`` "cpu" repeats the host's
    one device, for the tests)."""
    import torch

    return [torch.device(kind, i) if kind == "cuda" else torch.device(kind)
            for i in range(cell["chips"])]


def banned_modules(names) -> List[str]:
    """Loaded modules whose whole top-level name is one of ``names``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(names))


def load_cell(bench: dict, name: str) -> tuple:
    """(cell, configuration, mix, limits) of the cell ``name``, each found by name."""
    cell = find(bench["workloads"], name, "workload")
    entry = find(bench["configs"], cell["config"], "configuration")
    with open(os.path.join(os.path.dirname(HERE), entry["file"])) as f:
        config = json.load(f)
    return (cell, config, load_json("traffic", f"{cell['traffic']}.json"),
            load_json("limits", f"{name}.json"))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, devs: list,
             t_start: float) -> dict:
    """Set the cell up, measure its window, read its metrics and check its
    output against the reference: the result line, whose ``checks`` holds
    each compared number beside its limit."""
    import torch

    from tracing import Recorder

    cell, config, mix, limits = load_cell(bench, name)
    device = devs[0]
    cuda = device.type == "cuda"
    parts = {"process and imports": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.set_device(device)
        for d in devs:
            torch.empty(1, device=d)  # the context, before its memory statistics
            torch.cuda.reset_peak_memory_stats(d)
    parts["context"] = time.perf_counter() - t_start - parts["process and imports"]
    driver = driver_module(mix["driver"]).DRIVER(config, mix, seed, devs, limits)
    driver.setup()
    if cuda:
        for d in devs:
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_start
    print("setup parts (s): " + json.dumps(dict(parts, **driver.parts)), file=sys.stderr,
          flush=True)
    recorder = Recorder(len(devs)) if trace else None
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    driver.window(seconds, recorder)
    peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in devs) if cuda else 0
    run_trace = recorder.trace() if recorder is not None else None
    e2e = dict(driver.end_to_end(), setup_s=setup_s)
    record = driver.record
    driver.release()
    checks = driver.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        run = SimpleNamespace(cell=name, config=config, mix=mix, record=record, trace=run_trace,
                              peak=config["peak_flops"])
        metrics = {}
        for m in bench["per_layer"]:
            if reports(m, name):
                value = metric_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if reports(m, name):
                if m["name"] not in e2e:
                    raise SystemExit(f"{name} reports {m['name']}, which its driver does not give")
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": cell["chips"], "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": correct, "attempted": driver.attempted(), "failed": 0,
              "metrics": metrics, "device": dev_info}
    if run_trace is not None:
        dev_info.update(busy_s=run_trace.busy_s, window_s=run_trace.window_s)
        result["breakdown"] = {"device_ops": run_trace.top_ops(), "idle_gaps": run_trace.idle_by_span()}
    result["checks"] = checks
    return result
