"""Host seconds of the traced restart's ``ckpt.alloc`` spans: the device
buffers and the pinned ring of both waves, on the loop's thread and the
tail's."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_unit(run, "loop", "ckpt.alloc")
