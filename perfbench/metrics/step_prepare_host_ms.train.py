"""Host milliseconds a step in the program's ``step.prepare`` span (the
zeroed gradient tree and the model's leaf views), over the traced steps
of the timeline window."""

from perfbench import program_spans


def read(run):
    s = program_spans.mean_per_unit(run, "step", "step.prepare")
    return None if s is None else 1e3 * s
