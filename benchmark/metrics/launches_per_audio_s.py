"""The host's launch stream into the model: device operations the trace
holds over the seconds of audio the window rendered."""


def read(run):
    if run.trace is None or not run.trace.n_ops or not run.record.get("audio_s"):
        return None
    return run.trace.n_ops / run.record["audio_s"]
