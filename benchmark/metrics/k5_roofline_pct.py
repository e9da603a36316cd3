"""Kernels K5a and K5b (``ops/wavenet_train.py``, ``csrc/wavenet_train.cu``):
the least time of each step's save-forward and backward chain, from the
batch's shape, over the device time of their kernels."""

import roofline

K5 = {"save_gate_kernel", "save_out_kernel", "step_proj_kernel", "chain_gate_kernel",
      "chain_dy_kernel"}


def read(run):
    shapes = run.record.get("shapes")
    spent = run.trace.kernel_s(K5) if run.trace is not None else None
    if not shapes or not spent:
        return None
    hp = run.config["hparams"]
    c, h, n = hp["residual_channels"], hp["hidden_size"], hp["residual_layers"]
    least = sum(roofline.bound_s(*roofline.k5_save(b, t, c, h, n))
                + roofline.bound_s(*roofline.k5_chain(b, t, c, n)) for b, t in shapes)
    return 100.0 * least / spent
