"""Process-group distribution: the pipeline's scaling axes on ``torch.distributed``.

Counterpart of ``elasticreconstruction_tpu/dist``. Every function takes an
explicit process group (default: the world group) and runs on the device its
caller gives; nothing picks a backend or a device on its own.

- ``mesh``: ``init_group``, ``spawn_ranks`` and the even shards of a leading axis.
- ``comm``: the four collectives the paths use, in place of the ones XLA
  inserted in the reference; under gloo, CUDA tensors go through host memory
  where gloo takes none.
- ``pair_sharding``: data-parallel pair registration, no collective until the
  results are gathered.
- ``ring``: fragment-sharded all-pairs registration, blocks passed around the
  ring, a half walk.
- ``pgo_dist``: pose-graph GN with edge-sharded normal equations, summed, and
  the small dense solve on every rank.
- ``slac_dist``: FragmentOptimizer PCG with correspondence-sharded products,
  one sum a product.
- ``volume_sharding``: the scene TSDF in x-slabs, fused without collectives,
  meshed with a halo of neighbouring planes.
- ``dryrun``: one step of every path on ranks started for it.
"""

from . import comm, dryrun, mesh, pair_sharding, pgo_dist, ring, slac_dist, volume_sharding
from .mesh import init_group, spawn_ranks

__all__ = [
    "comm",
    "dryrun",
    "mesh",
    "pair_sharding",
    "ring",
    "pgo_dist",
    "slac_dist",
    "volume_sharding",
    "init_group",
    "spawn_ranks",
]
