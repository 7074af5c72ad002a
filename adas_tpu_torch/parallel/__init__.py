"""The UFLDv2 trainer and its checkpoints (port of ``adas_tpu/parallel``'s
``train.py`` and ``checkpoint.py``) on one GPU: the mesh, the sharding
rules and the sharded stream step are not ported (``ROADMAP.md``)."""
from .checkpoint import latest_checkpoint, restore_train_state, save_train_state
from .train import make_ufld_train_state, make_ufld_train_step, ufld_loss

__all__ = [
    "latest_checkpoint",
    "make_ufld_train_state",
    "make_ufld_train_step",
    "restore_train_state",
    "save_train_state",
    "ufld_loss",
]
