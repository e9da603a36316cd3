"""Nothing the benchmark runs loads JAX or the JAX package, judged by each
loaded module's whole top-level name (the port's name begins with the JAX
package's); the reference loads nothing of the port either. Each check runs
in a fresh interpreter."""

import os
import subprocess
import sys

import bench_tiny

BANNED = ("jax", "jaxlib", "flax", "prodiff_tpu")
PRELUDE = f"""
import sys
sys.path[:0] = [{bench_tiny.BENCH!r}, {bench_tiny.HERE!r}, {bench_tiny.ROOT!r}]
def top():
    return {{m.split(".")[0] for m in list(sys.modules)}}
"""


def run(body: str) -> str:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", PRELUDE + body], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_reference_loads_neither_jax_nor_the_port():
    out = run("import reference.svs\nprint(sorted(top() & {'jax', 'jaxlib', 'flax', "
              "'prodiff_tpu', 'prodiff_tpu_torch'}))")
    assert out.strip() == "[]"


def test_harness_metrics_and_a_whole_run_load_no_jax():
    body = """
import glob, os
import harness, driver, generate, roofline, tracing, weights, control
for path in glob.glob(os.path.join(harness.HERE, "metrics", "*.py")):
    harness.metric_reader(os.path.basename(path)[:-3])
for path in glob.glob(os.path.join(harness.HERE, "drivers", "*.py")):
    harness.driver_module(os.path.basename(path)[:-3])
import bench_tiny
for mix in ("song", "train"):
    d = bench_tiny.driver(mix)
    d.setup(); d.window(0.3); d.release(); d.check()
print(sorted(top() & set(%r)))
print("prodiff_tpu_torch" in top())
""" % (BANNED,)
    lines = run(body).strip().splitlines()
    assert lines[-2:] == ["[]", "True"]
