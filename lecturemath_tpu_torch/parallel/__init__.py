"""Scale-out: device meshes over the data axis (cards and processes), the
cross-replica BatchNorm, frame-sharded inference, the local launch of the
training CLIs, and the host-side lecture work queue."""
from .mesh import MeshSpec, make_mesh, shard_params, shard_batch
