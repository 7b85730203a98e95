"""The train state: step count, model and optimizer (counterpart of
gdrnet_tpu/engine/train_state.py).

The JAX package's create_train_state initialises the parameters itself. Here
the model comes built, with its weights loaded from a state dict or set by
models.gdrn.init_weights; its parameters and BN buffers are the state's, and
the optimizer holds the rest.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    step: int  # train steps taken, skipped ones included (DropBlock's progress)
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)
