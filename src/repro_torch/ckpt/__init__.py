from repro_torch.ckpt.checkpoint import Checkpointer  # noqa: F401
from repro_torch.ckpt.delta import (DEFAULT_DIFF_CHUNK, LayeredReader,  # noqa: F401
                                    build_layer_map, changed_ranges, chunk_crcs)
from repro_torch.ckpt.index import TensorIndex, TensorEntry  # noqa: F401
from repro_torch.ckpt.plan import (RestorePlan, ReadOp, Segment,  # noqa: F401
                                   TensorPlan, build_restore_plan,
                                   dim_slices_for_spec, execute_plan,
                                   plan_for_rank, read_plan, tensor_ranges)
