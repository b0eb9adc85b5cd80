"""Host milliseconds a step in the loader's ``data.load`` span (the
stream's rows drawn and copied to the card), over the traced restart's
steps."""

from perfbench import program_spans


def read(run):
    window = program_spans.units(run, "loop")
    if not window:
        return None
    loads = [r for unit in window for r in unit if r.name == "data.load"]
    if not loads:
        return None
    return 1e3 * sum(map(program_spans.seconds, loads)) / len(loads)
