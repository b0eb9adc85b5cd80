"""The H100's roofline: its peak rates, model FLOPs and the step-level
report (``analysis``: ``analyze``, ``format_table``), the count of what a
step runs (``step_cost.analytic_cost``), and the cost of the port's own
kernels from their shapes and launch configs (``kernel_cost``), which the
kernels' FLOP formulas, their bounds and the autotuner's pruning share.
The dry run over every (architecture x shape) is ``launch/dryrun.py``."""
