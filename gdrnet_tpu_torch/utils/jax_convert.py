"""JAX package variables -> the port's state_dict, and the JAX package's
Ranger state -> the port's Ranger state_dict.

The exact inverse of gdrnet_tpu/utils/torch_convert.py:convert_torch_state_dict:
it takes the `params` and `batch_stats` trees of a gdrnet_tpu GDRN (as numpy
arrays, or anything numpy can read) and returns a state_dict in the
reference's key layout, which the port's modules use:

  conv   kernel [kh,kw,in,out] -> weight [out,in,kh,kw]   (transpose 3,2,0,1)
  convT  kernel [kh,kw,in,out] -> weight [in,out,kh,kw]   (transpose 2,3,0,1)
  linear kernel [in,out]       -> weight [out,in]
  pnp_net.fc1: flax flattens (H, W, C), the port flattens (C, H, W)
  BN     scale/bias, mean/var  -> weight/bias, running_mean/running_var
  GN     scale/bias            -> weight/bias
"""

from __future__ import annotations

import numpy as np
import torch


def _conv_w(k):
    return np.transpose(k, (3, 2, 0, 1))


def _convT_w(k):
    return np.transpose(k, (2, 3, 0, 1))


def _lin_w(k):
    return np.transpose(k, (1, 0))


def _lin_w_to_chw(k, c: int):
    """fc kernel [h*w*c (HWC order), out] -> torch weight [out, c*h*w]."""
    out = k.shape[1]
    h = int(round((k.shape[0] // c) ** 0.5))
    if h * h * c != k.shape[0]:
        raise ValueError(f"fc1 input {k.shape[0]} is not c*h*h for c={c}")
    return k.T.reshape(out, h, h, c).transpose(0, 3, 1, 2).reshape(out, -1)


def _rot_head_index(num_layers: int, norm: str) -> dict[tuple[str, ...], tuple[int, str]]:
    """flax path under rot_head -> (features index, kind), the reference's
    ModuleList order: deconv, norm, relu, then per round [upsample] + 2x
    (conv, norm, relu), then the out conv."""
    inner = "BatchNorm_0" if norm == "BN" else "GroupNorm_0"
    kind = "bn" if norm == "BN" else "gn"
    m = {("deconv",): (0, "convT"),
         ("deconv_bn" if norm == "BN" else "deconv_gn",): (1, kind)}
    idx = 3
    for i in range(num_layers):
        if i >= 1:
            idx += 1
        for half in ("a", "b"):
            m[(f"conv{i}_{half}", "Conv_0")] = (idx, "conv")
            m[(f"conv{i}_{half}", inner)] = (idx + 1, kind)
            idx += 3
    m[("out_conv",)] = (idx, "conv")
    return m


def _pnp_index(num_layers: int, norm: str) -> dict[tuple[str, ...], tuple[int, str]]:
    inner, kind = ("GroupNorm_0", "gn") if norm == "GN" else ("BatchNorm_0", "bn")
    names = [f"conv{i}" for i in range(3)] + [f"conv_extra{i}" for i in range(num_layers - 3)]
    m = {}
    for i, name in enumerate(names):
        m[(name, "Conv_0")] = (3 * i, "conv")
        m[(name, inner)] = (3 * i + 1, kind)
    return m


def _backbone_key(path: tuple[str, ...]) -> tuple[str, str]:
    head = path[0]
    if head in ("conv1", "bn1"):
        return head, "conv" if head == "conv1" else "bn"
    layer, block = head.rsplit("_", 1)  # "layer2_0"
    base = f"{layer}.{block}"
    sub = path[1]
    if sub.startswith("Conv_"):
        return f"{base}.conv{int(sub[5:]) + 1}", "conv"
    if sub.startswith("BatchNorm_"):
        return f"{base}.bn{int(sub[10:]) + 1}", "bn"
    if sub == "downsample_conv":
        return f"{base}.downsample.0", "conv"
    if sub == "downsample_bn":
        return f"{base}.downsample.1", "bn"
    raise KeyError(f"unmapped backbone path: {path}")


def _leaves(tree: dict, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def jax_to_torch(params: dict, batch_stats: dict | None = None,
                 head_num_layers: int = 3, head_norm: str = "BN",
                 pnp_norm: str = "GN", pnp_num_layers: int = 3) -> dict[str, torch.Tensor]:
    """gdrnet_tpu GDRN (params, batch_stats) -> the port's state_dict.

    Every leaf must map to a key; an unknown path raises. BatchNorm layers
    also get `num_batches_tracked` = 0, so the result loads with strict=True."""
    rot_map = _rot_head_index(head_num_layers, head_norm)
    pnp_map = _pnp_index(pnp_num_layers, pnp_norm)
    pnp_featdim = None
    out: dict[str, torch.Tensor] = {}

    def module_key(path: tuple[str, ...]) -> tuple[str, str]:
        top, rest = path[0], path[1:]
        if top == "backbone":
            key, kind = _backbone_key(rest)
            return f"backbone.{key}", kind
        if top == "rot_head":
            idx, kind = rot_map[rest]
            return f"rot_head_net.features.{idx}", kind
        if top == "pnp_net":
            if rest[0] in ("fc1", "fc2", "fc_r", "fc_t"):
                return f"pnp_net.{rest[0]}", "lin"
            idx, kind = pnp_map[rest]
            return f"pnp_net.features.{idx}", kind
        raise KeyError(f"unmapped path: {'/'.join(path)}")

    param_leaves = list(_leaves(params))
    for path, v in param_leaves:  # fc1's (C, H, W) needs the last conv's width
        if path[0] == "pnp_net" and path[-1] == "kernel" and v.ndim == 4:
            pnp_featdim = v.shape[-1]
    for path, v in param_leaves:
        key, kind = module_key(path[:-1])
        field = path[-1]
        if field == "kernel":
            if kind == "conv":
                w = _conv_w(v)
            elif kind == "convT":
                w = _convT_w(v)
            elif key == "pnp_net.fc1":
                w = _lin_w_to_chw(v, pnp_featdim)
            else:
                w = _lin_w(v)
            out[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        elif field == "scale":
            out[f"{key}.weight"] = torch.from_numpy(v.copy())
        elif field == "bias":
            out[f"{key}.bias"] = torch.from_numpy(v.copy())
        else:
            raise KeyError(f"unknown param field: {'/'.join(path)}")
    for path, v in _leaves(batch_stats or {}):
        key, kind = module_key(path[:-1])
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        out[f"{key}.{name}"] = torch.from_numpy(v.copy())
        out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def _find_state(tree, fields: set[str]):
    """The first namedtuple under `tree` (tuples, lists, namedtuples) that
    has every one of `fields`."""
    if hasattr(tree, "_fields") and fields <= set(tree._fields):
        return tree
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _find_state(item, fields)
            if found is not None:
                return found
    return None


def ranger_state_to_torch(opt_state, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          **convert_kwargs) -> dict:
    """The JAX package's Ranger state (optax LookaheadState(inner, slow,
    count) with a ScaleByRAdamState(count, mu, nu) inside, possibly under a
    clip chain or MultiSteps, whose partial sum is not carried: convert at an
    update boundary) -> a state_dict for `optimizer`, the port's
    Ranger over `model`'s parameters. mu, nu and slow go through jax_to_torch's
    key and layout mapping (convert_kwargs as for jax_to_torch), so a JAX run
    of N steps continues as a torch run."""
    look = _find_state(opt_state, {"inner", "slow", "count"})
    radam = None if look is None else _find_state(look.inner, {"count", "mu", "nu"})
    if radam is None:
        raise ValueError("no LookaheadState with a ScaleByRAdamState inside in opt_state")
    count = int(np.asarray(look.count))
    if count != int(np.asarray(radam.count)):
        raise ValueError(f"Lookahead count {count} != RAdam count {int(np.asarray(radam.count))}")
    trees = {name: jax_to_torch(tree, None, **convert_kwargs)
             for name, tree in (("mu", radam.mu), ("nu", radam.nu), ("slow", look.slow))}
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups
                                            for p in g["params"])}
    state: dict = {}
    for name, p in model.named_parameters():
        state[index[id(p)]] = {k: trees[k][name].to(p.device) for k in trees}
    device = next(model.parameters()).device
    shared = {"count": torch.tensor(count, device=device),
              "mini_step": torch.tensor(0, device=device)}
    if optimizer.accum_steps > 1:
        shared["acc"] = torch.zeros(sum(p.numel() for p in model.parameters()), device=device)
    state["shared"] = shared
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
