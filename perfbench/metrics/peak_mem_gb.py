"""The card's largest allocation over the window,
``torch.cuda.max_memory_allocated()`` after a reset at its start, in GB."""


def read(run):
    peak = run.window.get("peak_bytes")
    return peak / 1e9 if peak is not None else None
