"""Scale-out: device meshes (cards and processes) with a data axis and a
model axis, the cross-replica BatchNorm, frame-sharded inference with the
model axis's channel and height shards, the local launch of the training
CLIs, and the host-side lecture work queue."""
from .mesh import MeshSpec, make_mesh, shard_params, shard_batch
