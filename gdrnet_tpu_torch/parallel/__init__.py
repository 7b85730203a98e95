"""Data and model parallelism over torch.distributed (counterpart of
gdrnet_tpu/parallel): the world, its (data, model) grid and the per-rank
batch, the model axis's sharded layers (parallel/tensor_parallel.py), local
replicas for testing and serving, and BatchNorm over the global batch. The
helpers over processes are in parallel/multihost.py."""

from gdrnet_tpu_torch.parallel.mesh import (
    ddp_model,
    local_batch_size,
    local_devices,
    local_dp_setup,
    param_partition,
    resolve_world,
    split_predict,
)
from gdrnet_tpu_torch.parallel.sync_bn import SyncBatchNorm2d, convert_sync_bn
from gdrnet_tpu_torch.parallel.tensor_parallel import shard_model

__all__ = ["SyncBatchNorm2d", "convert_sync_bn", "ddp_model", "local_batch_size", "local_devices",
           "local_dp_setup", "param_partition", "resolve_world", "shard_model", "split_predict"]
