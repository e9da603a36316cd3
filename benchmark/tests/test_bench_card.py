"""On the card, at each cell's own size and one seed with a short window:
the program's numbers stay within the cell's limits and the control (the
reference in TF32 in the program's place) exceeds at least one of them.

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_bench_card.py
"""

import bench_tiny
import pytest

import harness

BENCH = harness.load_benchmark(bench_tiny.ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_program_within_limits_control_beyond(card, cell):
    spec, config, mix, limits = harness.load_cell(BENCH, cell)
    if card < spec["chips"]:
        pytest.skip(f"{cell} needs {spec['chips']} CUDA cards; this machine has {card}")
    d = harness.driver_module(mix["driver"]).DRIVER(config, mix, 2 ** 31 + 101,
                                                    harness.devices(spec), limits)
    d.setup()
    d.window(2.0)
    d.release()
    checks = d.check()
    assert all(v["value"] <= v["limit"] for v in checks.values()), checks
    control = d.control()
    assert any(control[k] > limits[k] for k in control), (control, limits)
