"""The optimizer state's DEFERRED tail of each restore, read through the
pinned ring onto the card: ``Checkpointer.timings["tail_s"]``, averaged
over the window's restarts."""


def read(run):
    return run.window.get("tail_s")
