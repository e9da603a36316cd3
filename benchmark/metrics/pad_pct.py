"""Front end (``infer/handler.py`` bucket batching): padded mel frames over
the frames rendered, in the window's batches."""


def read(run):
    batches = run.record.get("batches")
    if not batches:
        return None
    total = sum(len(b["lengths"]) * b["t_mel"] for b in batches)
    return 100.0 * (total - sum(sum(b["lengths"]) for b in batches)) / total
