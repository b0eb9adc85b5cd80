"""The whole step's share of the card's bf16 peak: the model FLOPs of a
step (``yardstick.step_model_flops``: 6 N T, N counted from the
configuration, and the SSD scan's own, no recomputation) over the window's
seconds per step, in %."""

from perfbench import generator, yardstick


def read(run):
    w = run.window
    if not w.get("steps"):
        return None
    t = run.traffic
    flops = yardstick.step_model_flops(
        run.cfg, t["batch"], t["seq_len"],
        generator.count_params(run.cfg))
    return 100 * flops / (w["seconds"] / w["steps"]) / \
        yardstick.PEAK_BF16_FLOPS
