"""Kernel K1 (``ops/wavenet_stack.py``, ``csrc/wavenet_stack.cu``): the
least time of every denoiser call the window made, from its shapes, over
the device time of K1's kernels."""

import roofline

K1 = {"step_proj_kernel", "cond_kernel", "chain_kernel"}


def read(run):
    batches = run.record.get("batches")
    spent = run.trace.kernel_s(K1) if run.trace is not None else None
    if not batches or not spent:
        return None
    hp = run.config["hparams"]
    least = sum(run.record["steps"] * roofline.bound_s(*roofline.k1(
        len(b["lengths"]), b["t_mel"], hp["residual_channels"], hp["hidden_size"],
        hp["residual_layers"])) for b in batches)
    return 100.0 * least / spent
