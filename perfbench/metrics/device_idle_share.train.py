"""1 - device busy / host seconds over the traced steps, in %: busy is the
union of every device operation's interval in the profiler's trace."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100 * (1 - tr.busy_s / tr.window_s)
