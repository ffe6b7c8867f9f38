"""Scale-out over several devices: the sharded MSM and NTT on
``torch.distributed``.

Counterpart of the JAX package's ``parallel/``.  The port runs one process a
device (``torchrun``'s ranks): the MSM's points and the NTT's columns are cut
over the ranks, each rank runs the local kernels on its block, and collectives
(``all_gather`` of the chunk points, ``all_to_all_single`` for the NTT's
transposes; NCCL on CUDA devices, gloo on the CPU) join the blocks.
"""

from .mesh import default_mesh, init_distributed, shard_axis
from .msm import msm_sharded, msm_g1_sharded, msm_g2_sharded
from .ntt import (
    ntt_sharded,
    intt_sharded,
    ntt_batch_sharded,
    coset_ntt_sharded,
    coset_intt_sharded,
    build_step_twiddles,
)

__all__ = [
    "default_mesh",
    "init_distributed",
    "shard_axis",
    "coset_ntt_sharded",
    "coset_intt_sharded",
    "msm_sharded",
    "msm_g1_sharded",
    "msm_g2_sharded",
    "ntt_sharded",
    "intt_sharded",
    "ntt_batch_sharded",
    "build_step_twiddles",
]
