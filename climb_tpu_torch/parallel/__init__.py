"""Scale-out over ``torch.distributed``: meshes, sharding rules, tensor and
pipeline parallelism (counterpart of ``climb_tpu/parallel``). The sharding
names load on first use: ``parallel.sharding`` reads the checkpoint layout,
whose module imports the models, which import ``parallel.pipeline``."""

from climb_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    REPLICA_AXIS,
    make_dp_pp_mesh,
    make_mesh,
    make_multislice_mesh,
)

_SHARDING = ("param_spec", "shard_model", "shard_batch", "replicate")

__all__ = ["make_mesh", "make_dp_pp_mesh", "make_multislice_mesh", "DATA_AXIS", "MODEL_AXIS",
           "PIPE_AXIS", "REPLICA_AXIS", *_SHARDING]


def __getattr__(name):
    if name in _SHARDING:
        from climb_tpu_torch.parallel import sharding

        return getattr(sharding, name)
    raise AttributeError(name)
