"""Host seconds of the traced restart's first ``step`` span: the first
step's host work on a fresh model (a cold caching allocator among it), its
kernels launched, before the loop reads its loss."""

from perfbench import program_spans


def read(run):
    window = program_spans.units(run, "loop")
    if not window:
        return None
    firsts = [min((r for r in unit if r.name == "step"),
                  key=lambda r: r.start_ns, default=None) for unit in window]
    if None in firsts:
        return None
    return sum(map(program_spans.seconds, firsts)) / len(firsts)
