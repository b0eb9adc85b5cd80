"""Host milliseconds a step in the program's ``step.optimizer`` span (the
lr, the gradient's clip and AdamW's update), over the traced steps of the
timeline window."""

from perfbench import program_spans


def read(run):
    s = program_spans.mean_per_unit(run, "step", "step.optimizer")
    return None if s is None else 1e3 * s
