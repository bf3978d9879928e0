"""Scale-out of the port: the batched multi-folio pipeline
(``process_batch``) and the ``torch.distributed`` mesh it, the
recognizer, the NW grid and the training step shard over (``mesh``,
``infer_dp``, ``train_dp``, ``multihost``)."""

from .batch import FolioResult, process_batch
from .mesh import data_model_mesh, make_mesh
from .train_dp import make_sharded_train_step, sharded_train_demo_step

__all__ = [
    "FolioResult",
    "process_batch",
    "make_mesh",
    "data_model_mesh",
    "make_sharded_train_step",
    "sharded_train_demo_step",
]
