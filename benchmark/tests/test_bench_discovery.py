"""A cell, a configuration, a traffic mix, a driver and a per-layer metric
added as new files and entries in a copy of the benchmark are found by name
with no edit to any file it had, and a cell's ``chips`` decides the devices
its driver is handed; and the command refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import bench_tiny


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(bench_tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(bench_tiny.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    b = tmp_path / "benchmark"
    (b / "configs" / "tiny-new.json").write_text(json.dumps(bench_tiny.config()))
    (b / "traffic" / "short-song.json").write_text(json.dumps(bench_tiny.mix("song")))
    (b / "limits" / "tiny-new.short-song.json").write_text(json.dumps(bench_tiny.LIMITS))
    (b / "metrics" / "phrases_per_batch.py").write_text(
        "def read(run):\n"
        "    b = run.record.get('batches')\n"
        "    return sum(len(x['lengths']) for x in b) / len(b) if b else None\n")
    bench["configs"].append({"name": "tiny-new", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/tiny-new.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny-new.short-song", "config": "tiny-new",
                               "traffic": "short-song", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_audio_s_per_s":
            m["workloads"].append("tiny-new.short-song")
    bench["per_layer"].append({"name": "phrases_per_batch", "unit": "phrases", "better": "higher",
                               "source": "program_counter", "layer": "front end",
                               "moves": "render_audio_s_per_s",
                               "workloads": ["tiny-new.short-song"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = f"""
import sys, json, torch
from types import SimpleNamespace
sys.path[:0] = [{str(b)!r}, {bench_tiny.ROOT!r}]
import harness
assert harness.HERE == {str(b)!r}
bench = harness.load_benchmark({str(tmp_path)!r})
cell = harness.find(bench["workloads"], "tiny-new.short-song", "workload")
result = harness.run_cell(bench, "tiny-new.short-song", 2 ** 31 + 5, 0.5, False,
                          harness.devices(cell, "cpu"), 0.0)
read = harness.metric_reader("phrases_per_batch")
print(json.dumps({{"correct": result["correct"], "e2e": sorted(result["metrics"]),
                  "per_batch": read(SimpleNamespace(record={{"batches": [{{"lengths": [1, 2]}}]}}))}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "e2e": ["render_audio_s_per_s", "setup_s"], "per_batch": 2.0}


NEW_DRIVER = '''
import time

import torch

from driver import Driver


class Sums(Driver):
    """Sums of seeded rows on every device handed in, for the window's seconds."""

    def setup(self):
        gen = torch.Generator().manual_seed(self.seed % 2 ** 63)
        self.rows = [torch.randn(self.mix["rows"], 64, generator=gen).to(d) for d in self.devices]

    def window(self, seconds, recorder=None):
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.out = [r.sum(1) for r in self.rows]
            n += 1
        self.record = {"seconds": time.perf_counter() - t0, "sums": n * len(self.rows)}

    def end_to_end(self):
        return {"sums_per_s": self.record["sums"] / self.record["seconds"]}

    def attempted(self):
        return self.record["sums"]

    def check(self):
        worst = max(float((o.cpu() - r.cpu().double().sum(1).float()).abs().max())
                    for o, r in zip(self.out, self.rows))
        return self.checks({"sum_gap": worst,
                            "devices_gap": abs(len(self.devices) - self.mix["devices"])})


DRIVER = Sums
FAULTS = ()
'''


def test_a_new_driver_and_a_two_chip_cell_need_no_edit(tmp_path):
    shutil.copytree(bench_tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(bench_tiny.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    b = tmp_path / "benchmark"
    (b / "drivers" / "sums.py").write_text(NEW_DRIVER)
    (b / "traffic" / "rows.json").write_text(json.dumps({"driver": "sums", "rows": 8,
                                                         "devices": 2}))
    (b / "configs" / "plain.json").write_text(json.dumps({"peak_flops": 1e12}))
    (b / "limits" / "plain.rows.json").write_text(json.dumps({"sum_gap": 1e-4,
                                                              "devices_gap": 0}))
    bench["configs"].append({"name": "plain", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/plain.json", "why": "a test"})
    bench["workloads"].append({"name": "plain.rows", "config": "plain", "traffic": "rows",
                               "chips": 2, "why": "a test"})
    bench["end_to_end"].append({"name": "sums_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["plain.rows"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = f"""
import sys, json
sys.path[:0] = [{str(b)!r}, {bench_tiny.ROOT!r}]
import harness
bench = harness.load_benchmark({str(tmp_path)!r})
cell = harness.find(bench["workloads"], "plain.rows", "workload")
result = harness.run_cell(bench, "plain.rows", 2 ** 31 + 9, 0.2, False,
                          harness.devices(cell, "cpu"), 0.0)
print(json.dumps({{"correct": result["correct"], "e2e": sorted(result["metrics"]),
                  "count": result["device"]["count"], "checks": result["checks"]}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True, got
    assert got["e2e"] == ["setup_s", "sums_per_s"] and got["count"] == 2
    assert got["checks"]["devices_gap"]["value"] == 0


def test_the_command_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "svs-prodiff4-nsf44k.song", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=bench_tiny.ROOT, capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
