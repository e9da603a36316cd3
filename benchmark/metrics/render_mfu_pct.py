"""The model (``models/prodiff.py``, the sampler, ``nsf_hifigan.py``): its
operations on real tokens and frames (``roofline.render_flops``) over the
window's seconds at the configuration's peak."""

import roofline


def read(run):
    batches = run.record.get("batches")
    if not batches:
        return None
    hp, h = run.config["hparams"], run.config["vocoder"]
    flops = sum(roofline.render_flops(n, m, hp, h, run.record["steps"])
                for b in batches for n, m in zip(b["tokens"], b["lengths"]))
    return 100.0 * flops / (run.record["seconds"] * run.peak)
