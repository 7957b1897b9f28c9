"""Decoder frames completed in the window (steps x outputs_per_step x rows
of every call that finished), over the window's seconds."""


def read(run):
    r = run.hp["outputs_per_step"]
    frames = sum(c["steps"] * r * c["rows"] for c in run.calls)
    return frames / run.window_s if run.calls else None
