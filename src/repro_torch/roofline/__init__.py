"""The H100's roofline: its peak rates and model FLOPs (``analysis``) and
the cost of the port's own kernels from their shapes and launch configs
(``kernel_cost``), which the autotuner's pruning prices candidates with.
The step-level report over a whole model (``analyze``, ``format_table``,
the dry run) is ROADMAP A.9."""
