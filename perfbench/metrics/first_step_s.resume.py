"""The first step after each restore: from the moment the restore had
handed over the parameters and finished its tail to the host's read of
the step's loss, averaged over the window's restarts."""


def read(run):
    return run.window.get("first_step_s")
