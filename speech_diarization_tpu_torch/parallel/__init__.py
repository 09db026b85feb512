"""Multi-device parallelism over a mesh of torch devices, driven by one
process (the JAX package's ``parallel/``).

* **dp** (data): window batches, files' grids and training batches cut into
  row blocks, one per dp row of the mesh.
* **tp** (tensor): the leaves named by a step's patterns (ECAPA's MFA /
  attention / embedding convolutions and the AAM classifier) stored split
  along their first dim over a row's tp devices and gathered where used.

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh`` and XLA inserts the collectives.  So is the port: a
:class:`~.mesh.Mesh` is a ``[dp, tp]`` array of ``torch.device`` that may
name one device more than once (the virtual mesh of the tests and of a
one-card machine), and the collectives are differentiable copies between
its devices (``Tensor.to``), combined on its first device.  No process
group is started: two ranks cannot share one card under NCCL.
"""
from .inference import make_sharded_encode_fn, make_sharded_framewise_fn
from .mesh import default_mesh_shape, make_mesh
from .sharding import batch_spec, param_partition_specs, replicate, shard_batch

__all__ = [
    "make_sharded_encode_fn",
    "make_sharded_framewise_fn",
    "make_mesh",
    "default_mesh_shape",
    "shard_batch",
    "replicate",
    "batch_spec",
    "param_partition_specs",
]
