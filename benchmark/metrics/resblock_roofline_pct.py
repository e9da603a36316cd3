"""Kernels K2/K3 (``ops/resblock.py``, ``csrc/resblock.cu``): the least
time of every ResBlock1 stage the window's vocoder calls ran, from their
shapes, over the device time of the stage kernels."""

import roofline

STAGE = {"conv_kernel", "c8_stage_kernel"}


def read(run):
    batches = run.record.get("batches")
    spent = run.trace.kernel_s(STAGE) if run.trace is not None else None
    if not batches or not spent:
        return None
    h = run.config["vocoder"]
    least = 0.0
    for b in batches:
        t, c = b["t_mel"], h["upsample_initial_channel"]
        for u in h["upsample_rates"]:
            t, c = t * u, c // 2
            least += roofline.bound_s(*roofline.resblock_stage(
                len(b["lengths"]), t, c, h["resblock_kernel_sizes"],
                len(h["resblock_dilation_sizes"][0])))
    return 100.0 * least / spent
