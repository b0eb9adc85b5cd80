"""Host milliseconds a step in the program's ``step.backward`` span
(autograd's backward, its kernels launched), over the traced steps of the
timeline window."""

from perfbench import program_spans


def read(run):
    s = program_spans.mean_per_unit(run, "step", "step.backward")
    return None if s is None else 1e3 * s
