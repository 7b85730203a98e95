"""Fold BatchNorm running statistics into the conv that feeds it, for
inference (counterpart of gdrnet_tpu/utils/fold_bn.py:23-133).

With y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta, per output
channel:
    weight' = weight * gamma / sqrt(var + eps)
    BN'     = a pure bias add: weight 1, running_mean 0, running_var 1 - eps,
              bias beta - mean * gamma / sqrt(var + eps)
so the multiplier moves into the conv and the BN module stays, with the same
state_dict keys: a folded model loads and converts like any other. The
arithmetic is float64, as the JAX package's numpy fold, then cast to f32.

The pairs are the ones the JAX package's `_conv_for_bn` makes: every
BatchNorm2d whose preceding sibling module is a Conv2d or ConvTranspose2d
(the backbone's conv1/bn1, each block's convK/bnK and downsample.0/.1, the
head's features.<i-1>/<i>, its deconv and deconv BN). GroupNorm (ConvPnPNet's
default) is not folded, as in JAX. A ConvTranspose2d weight is
[in, out, kh, kw], so its per-output-channel scale runs along dim 1.
"""

from __future__ import annotations

import copy
import re

import torch
import torch.nn as nn

BN_EPS = 1e-5  # the JAX package's _EPS, and every BN of the port (models/layers.py)
# the only transposed conv of the port's GDRN (models/heads.py: features[0] is deconv_2x)
TRANSPOSED_CONVS = ("rot_head_net.features.0",)


def conv_bn_pairs(model: nn.Module) -> list[tuple[str, str, bool, float]]:
    """(conv name, BN name, transposed, eps) for each BatchNorm2d of `model`
    whose preceding sibling is a Conv2d or ConvTranspose2d."""
    pairs = []
    for parent_name, parent in model.named_modules():
        prev_name, prev = None, None
        for name, child in parent.named_children():
            if isinstance(child, nn.BatchNorm2d) and isinstance(
                    prev, (nn.Conv2d, nn.ConvTranspose2d)):
                pairs.append((f"{parent_name}.{prev_name}".lstrip("."),
                              f"{parent_name}.{name}".lstrip("."),
                              isinstance(prev, nn.ConvTranspose2d), float(child.eps)))
            prev_name, prev = name, child
    return pairs


def _pairs_from_keys(sd: dict) -> list[tuple[str, str, bool, float]]:
    """The same pairs from a state_dict of the port's GDRN, by key names."""
    pairs = []
    for key in sd:
        if not key.endswith(".running_var"):
            continue
        bn = key[: -len(".running_var")]
        if m := re.fullmatch(r"(.*)\.bn(\d+)", bn):  # conv1/bn1, a block's convK/bnK
            conv = f"{m[1]}.conv{m[2]}"
        elif (m := re.fullmatch(r"(.*)\.(\d+)", bn)) and int(m[2]) > 0:  # a list's i-1/i
            conv = f"{m[1]}.{int(m[2]) - 1}"
        else:
            continue
        if f"{conv}.weight" in sd and sd[f"{conv}.weight"].ndim == 4:
            pairs.append((conv, bn, conv in TRANSPOSED_CONVS, BN_EPS))
    return pairs


def fold_state_dict(sd: dict, pairs: list[tuple[str, str, bool, float]]) -> dict:
    """A copy of `sd` with each (conv, BN) pair folded; `sd` is untouched."""
    out = dict(sd)
    for conv, bn, transposed, eps in pairs:
        mean, var = sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"]
        inv = sd[f"{bn}.weight"].double() / torch.sqrt(var.double() + eps)
        w = sd[f"{conv}.weight"]
        shape = (1, -1, 1, 1) if transposed else (-1, 1, 1, 1)
        out[f"{conv}.weight"] = (w.double() * inv.reshape(shape)).to(w.dtype)
        out[f"{bn}.weight"] = torch.ones_like(mean)
        out[f"{bn}.bias"] = (sd[f"{bn}.bias"].double() - mean.double() * inv).to(mean.dtype)
        out[f"{bn}.running_mean"] = torch.zeros_like(mean)
        out[f"{bn}.running_var"] = torch.full_like(var, 1.0 - eps)
    return out


def fold_batch_norms(model_or_sd):
    """Fold an nn.Module (returns a folded deep copy) or a state_dict of the
    port's GDRN (returns a folded copy); the input is left as it was."""
    if isinstance(model_or_sd, nn.Module):
        folded = copy.deepcopy(model_or_sd)
        sd = {k: v.detach() for k, v in folded.state_dict().items()}
        folded.load_state_dict(fold_state_dict(sd, conv_bn_pairs(folded)))
        return folded
    sd = {k: v.detach() for k, v in model_or_sd.items()}
    return fold_state_dict(sd, _pairs_from_keys(sd))
