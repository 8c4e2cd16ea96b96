"""Multi-device execution over ``torch.distributed``: the (data, model)
mesh, Megatron sharding, sharded encode and the process-group plumbing
(counterpart of ``bert_tpu/parallel``)."""

from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh  # noqa: F401
from .sharding import check_tp_divisibility, split_dim  # noqa: F401
from .spmd import make_sharded_encode_fn, shard_params  # noqa: F401
