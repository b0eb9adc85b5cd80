"""The SSD operators' share of their roofline over the traced steps, in %:
the sum over every forward and backward call of its least time (the larger
of its least FLOPs over the bf16 peak and its bytes, each input read and
each output written once, over the HBM rate), from the call's shapes, over
the device time of the kernels launched inside those operators."""

from perfbench import yardstick

FWD, BWD = "repro_torch::ssd_fwd", "repro_torch::ssd_bwd"


def read(run):
    tr = run.ops
    if tr is None:
        return None
    least = 0.0
    for name, cost in ((FWD, yardstick.ssd_fwd_cost),
                       (BWD, yardstick.ssd_bwd_cost)):
        for shapes in tr.calls(name):
            b, s, h, p = shapes[0]
            g, n = shapes[3][2], shapes[3][3]
            least += yardstick.least_seconds(*cost(b, s, h, p, g, n))
    spent = tr.op_seconds((FWD, BWD))
    return 100 * least / spent if least and spent else None
