"""Meshes, data-parallel training and serving, spatial halo sharding,
channel tensor parallelism and multi-process init (larvanet_tpu/parallel)."""

from larvanet_tpu_torch.parallel.mesh import make_mesh, shard_batch, replicate
from larvanet_tpu_torch.parallel.halo import halo_exchange, spatial_sharded_forward
