"""Device-mesh parallelism (port of ``adas_tpu/parallel``): mesh
construction, the sharding rules, sharded inference over stream batches,
the UFLD trainer (data parallel over ``data``, its MLP head tensor
parallel over ``model``) and its checkpoints.  One process drives every
device of a mesh, as JAX does (``parallel/mesh.py``)."""
from .checkpoint import latest_checkpoint, restore_train_state, save_train_state
from .mesh import Mesh, make_mesh
from .sharding import (
    MeshReplicas,
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    param_shardings,
    replicated_sharding,
    shard_ufld_params,
    tp_param_spec,
)
from .streams import make_sharded_stream_step
from .train import make_ufld_train_state, make_ufld_train_step, ufld_loss

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_ufld_params",
    "tp_param_spec",
    "make_sharded_stream_step",
    "make_ufld_train_state",
    "make_ufld_train_step",
    "Mesh",
    "MeshReplicas",
    "NamedSharding",
    "PartitionSpec",
    "param_shardings",
    "latest_checkpoint",
    "restore_train_state",
    "save_train_state",
    "ufld_loss",
]
