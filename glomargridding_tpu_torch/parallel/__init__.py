"""Scaling over several devices: the (grid x ens) mesh and the sharded
kriging pipelines.

Port of ``glomargridding_tpu/parallel``. The reference is
single-controller: one process and a ``Mesh`` over ``jax.devices()``,
with ``shard_map`` placing the collectives. This package keeps that
model: one process drives a ``Mesh`` of device slots (``make_mesh``), a
sharded value is a ``Sharded`` of per-slot blocks, and the collectives
(psum, the owner's broadcast, the ring shift, the row gathers) are plain
functions of the per-slot tensors in ``mesh``. It uses no
``torch.distributed``, NCCL, ``DTensor`` or process group: the
reference has no multi-host mode to port, and a process group would
make a one-card run a world of one rank in which every collective does
nothing. Slots may repeat a device: ``["cpu"] * 8`` in the tests,
``["cuda:0"] * 4`` on one card, one slot per card on a multi-GPU host.
On the card the sharded paths run the kernels of their single-device
counterparts (K1 in the kernel kriging, K3 and K4 in the ellipse
assembly and stream).
"""

from .mesh import make_mesh
from .kriging import (
    ensemble_kriging_step,
    sharded_ordinary_kriging,
)
from .kernel_kriging import sharded_kriging_from_kernel
from .linalg import (
    sharded_cholesky,
    sharded_mvn_logpdf,
    sharded_triangular_solve,
    sharded_whiten,
)
from .ellipse import (
    sharded_ellipse_covariance,
    sharded_ellipse_stream_operator,
    sharded_state_draws,
)
from .lowrank import (
    sharded_lowrank_ensemble_step,
    sharded_lowrank_kriging,
)

__all__ = [
    "ensemble_kriging_step",
    "make_mesh",
    "sharded_lowrank_ensemble_step",
    "sharded_lowrank_kriging",
    "sharded_cholesky",
    "sharded_triangular_solve",
    "sharded_ellipse_covariance",
    "sharded_ellipse_stream_operator",
    "sharded_state_draws",
    "sharded_kriging_from_kernel",
    "sharded_mvn_logpdf",
    "sharded_whiten",
    "sharded_ordinary_kriging",
]
