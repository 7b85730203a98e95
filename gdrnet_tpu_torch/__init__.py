"""gdrnet_tpu_torch: the PyTorch and CUDA port of gdrnet_tpu for NVIDIA Hopper.

The JAX package `gdrnet_tpu` is the reference this port is tested against;
the module paths here mirror its paths. Nothing in this package imports JAX
or the JAX package.

Entry points that take a `device` run on the CUDA card unless the caller
passes another device (the CPU tests pass device="cpu"); without a card they
raise.

Layout:
  config/    the config system and defaults (a copy of gdrnet_tpu/config)
  ops/       rotation / pose / symmetry math on tensors, and the CUDA kernels' wrappers
  models/    nn.Modules: ResNet backbone, geometry head, ConvPnPNet (with DropBlock), GDRN
  engine/    the train state, the train step and the predict step
  losses/    the GDR-Net losses (xyz, mask, region, point matching, pose)
  solver/    Ranger and the learning-rate schedules
  eval/      pose errors and the in-process evaluator
  data/      synthetic ROI batches (numpy)
  utils/     weight and Ranger-state conversion from the JAX package
  csrc/      CUDA C++ sources and their build
"""

from __future__ import annotations

from gdrnet_tpu_torch.config import Config, base_config, load_config, merge_dict
from gdrnet_tpu_torch.engine.steps import make_train_step
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.solver.schedulers import build_lr_schedule

__all__ = ["base_config", "build_lr_schedule", "build_optimizer", "create_train_state",
           "load_config", "make_train_step", "merged_config"]


def merged_config(path: str) -> Config:
    """Framework defaults with the config file at `path` merged over them
    (what gdrnet_tpu/engine/train.py:setup does before its overrides)."""
    return Config(merge_dict(base_config().to_dict(), load_config(path).to_dict()))
