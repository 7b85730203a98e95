"""Data parallelism over torch.distributed (counterpart of gdrnet_tpu/parallel):
the world and the per-rank batch, local replicas for testing and serving, and
BatchNorm over the global batch. The helpers over processes are in
parallel/multihost.py."""

from gdrnet_tpu_torch.parallel.mesh import (
    ddp_model,
    local_batch_size,
    local_devices,
    local_dp_setup,
    resolve_world,
    split_predict,
)
from gdrnet_tpu_torch.parallel.sync_bn import SyncBatchNorm2d, convert_sync_bn

__all__ = ["SyncBatchNorm2d", "convert_sync_bn", "ddp_model", "local_batch_size", "local_devices",
           "local_dp_setup", "resolve_world", "split_predict"]
