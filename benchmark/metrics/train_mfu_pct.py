"""Model and trainer: forward and backward operations on the real frames
of the window's steps (``roofline.train_flops``) over the window's seconds
at the configuration's peak."""

import roofline


def read(run):
    rows = run.record.get("rows")
    if not rows:
        return None
    hp = run.config["hparams"]
    flops = sum(roofline.train_flops(t, f, hp) for batch in rows for f, t in batch)
    return 100.0 * flops / (run.record["seconds"] * run.peak)
