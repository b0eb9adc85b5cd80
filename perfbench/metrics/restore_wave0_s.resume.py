"""Wave 0 of each restore (the parameters, at CRITICAL), read and its last
copy onto the card waited for: ``Checkpointer.timings``' ``wave0_read_s``
+ ``wave0_copy_s``, averaged over the window's restarts."""


def read(run):
    return run.window.get("wave0_s")
