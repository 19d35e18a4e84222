"""Several devices: the process mesh, population sharding and the top-mu
merge over ``torch.distributed`` (port of ``pmfm_tpu/parallel``)."""
from .mesh import FRAME_AXIS, POP_AXIS, Mesh, initialize_multihost, make_mesh
from .sharded import evolve_sharded, sharded_generation_step

__all__ = [
    "FRAME_AXIS",
    "Mesh",
    "POP_AXIS",
    "evolve_sharded",
    "initialize_multihost",
    "make_mesh",
    "sharded_generation_step",
]
