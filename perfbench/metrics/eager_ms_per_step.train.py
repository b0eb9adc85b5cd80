"""Device milliseconds a step in kernels launched outside the program's
four kernel operators (``yardstick.OPS``): the eager elementwise, GEMM and
cross-entropy work, from the traced steps."""

from perfbench import yardstick


def read(run):
    tr = run.ops
    if tr is None or not tr.units or not tr.kernels_s:
        return None
    inside = tr.op_seconds(yardstick.OPS)
    return 1e3 * (tr.kernels_s - inside) / tr.units
