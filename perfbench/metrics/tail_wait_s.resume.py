"""Host seconds the traced restart's loop waits in its ``loop.tail_wait``
span: the kernels' build (a no-op once built) and the optimizer state's
DEFERRED tail, awaited before the first step."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_unit(run, "loop", "loop.tail_wait")
