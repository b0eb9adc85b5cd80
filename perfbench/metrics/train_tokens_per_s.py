"""Every token trained in the window over the window's host seconds, which
end in a synchronisation."""


def read(run):
    w = run.window
    return w["tokens"] / w["seconds"] if "tokens" in w else None
