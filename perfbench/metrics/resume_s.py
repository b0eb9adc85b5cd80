"""Seconds from the loop's call to resume a checkpoint to the host's read
of the first step's loss after it, averaged over the window's restarts."""


def read(run):
    return run.window.get("resume_s")
