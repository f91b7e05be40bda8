"""Data parallelism (counterpart of dpft_tpu/parallel): ranks, nodes,
dataset shards and collectives (``mesh``), and the global-batch BatchNorm
(``batchnorm``)."""

from dpft_tpu_torch.parallel.batchnorm import (  # noqa: F401
    GlobalBatchNorm2d, convert_batchnorm,
)
from dpft_tpu_torch.parallel.mesh import (  # noqa: F401
    agreed_timestamp, all_sum, barrier, data_parallel_size, distribute,
    gather_rows, init_distributed, launch, is_main, local_rank_index,
    local_world_size, node_count, node_rank, process_group,
    process_local_indices, rank, shard_dataset_for_process, shutdown,
    world_size,
)
