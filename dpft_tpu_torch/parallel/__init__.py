"""Data and tensor parallelism (counterpart of dpft_tpu/parallel): ranks,
nodes, the (data, model) mesh, dataset shards and collectives (``mesh``),
the global-batch BatchNorm (``batchnorm``) and the sharding of a model over
the 'model' axis (``tp``)."""

from dpft_tpu_torch.parallel.batchnorm import (  # noqa: F401
    GlobalBatchNorm2d, convert_batchnorm,
)
from dpft_tpu_torch.parallel.mesh import (  # noqa: F401
    agreed_timestamp, all_sum, barrier, data_group, data_parallel_size,
    data_world_size, distribute, gather_rows, gradient_sync,
    init_distributed, launch, is_main, local_rank_index, local_world_size,
    make_mesh, model_parallel, model_parallel_size, node_count, node_rank,
    process_group, process_local_indices, rank, shard_dataset_for_process,
    shutdown, world_size,
)
from dpft_tpu_torch.parallel.tp import (  # noqa: F401
    load_optimizer_state_dict, model_state_dict, optimizer_state_dict,
    place_tensor_parallel, shard_dims, tp_spec_for_shape,
)
