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
  models/    nn.Modules: ResNet backbone, geometry head, ConvPnPNet, GDRN
  engine/    the predict step
  eval/      pose errors and the in-process evaluator
  data/      synthetic ROI batches (numpy)
  utils/     weight conversion from the JAX package's variables
  csrc/      CUDA C++ sources and their build
"""

from __future__ import annotations

from gdrnet_tpu_torch.config import Config, base_config, load_config, merge_dict

__all__ = ["base_config", "load_config", "merged_config"]


def merged_config(path: str) -> Config:
    """Framework defaults with the config file at `path` merged over them
    (what gdrnet_tpu/engine/train.py:setup does before its overrides)."""
    return Config(merge_dict(base_config().to_dict(), load_config(path).to_dict()))
