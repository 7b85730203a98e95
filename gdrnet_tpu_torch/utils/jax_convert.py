"""JAX package variables -> the port's state_dict, the JAX package's
Ranger state -> the port's Ranger state_dict, and the JAX package's int8
activation scales <-> the port's.

The exact inverse of gdrnet_tpu/utils/torch_convert.py:convert_torch_state_dict:
it takes the `params` and `batch_stats` trees of a gdrnet_tpu GDRN (as numpy
arrays, or anything numpy can read) and returns a state_dict in the
reference's key layout, which the port's modules use:

  conv   kernel [kh,kw,in,out] -> weight [out,in,kh,kw]   (transpose 3,2,0,1)
  convT  kernel [kh,kw,in,out] -> weight [in,out,kh,kw]   (transpose 2,3,0,1)
  linear kernel [in,out]       -> weight [out,in]
  pnp_net.fc1 (ConvPnPNet) and trans_head_net.fc1: flax flattens (H, W, C),
         the port flattens (C, H, W)
  BN     scale/bias, mean/var  -> weight/bias, running_mean/running_var
  GN     scale/bias            -> weight/bias

Module names: backbone blocks' Conv_k / BatchNorm_k -> convK+1 / bnK+1 (the
Bottleneck's conv3 / bn3 too); rot_head -> rot_head_net.features.<i> (with
ROT_CONCAT every round has an upsample slot, which the converter reads off
conv0_a's input width); trans_head/conv<i> -> trans_head_net.features.<3i>
(and <3i+1> for its BN), fc1 / fc2 / fc_out -> fc1 / fc2 / fc3, as the JAX
package's torch_convert reads the reference; the point heads' Dense layers
keep their names (pnp_net.conv1, ..., pnp_net.fc_pose); the MTL
log-variances log_var_<name> keep theirs.

PVNet (models/pvnet.py) has its own: pvnet_jax_to_torch maps conv1 / bn1
and layer<s>_<b>/{convK, bnK, downsample, downsample_bn} into
resnet<depth>_8s.{conv1, bn1, layer<s>.<b>.{convK, bnK, downsample.0 / .1}},
fc_conv / fc_bn into resnet<depth>_8s.fc.{0,1}, conv8s / conv4s / conv2s /
convraw _conv / _bn into <name>.{0,1}, and head into head.
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


def _rot_head_index(num_layers: int, norm: str, concat: bool = False
                    ) -> dict[tuple[str, ...], tuple[int, str]]:
    """flax path under rot_head -> (features index, kind), the reference's
    ModuleList order: deconv, norm, relu, then per round [upsample] + 2x
    (conv, norm, relu), then the out conv; with concat, every round has its
    upsample."""
    inner = "BatchNorm_0" if norm == "BN" else "GroupNorm_0"
    kind = "bn" if norm == "BN" else "gn"
    m = {("deconv",): (0, "convT"),
         ("deconv_bn" if norm == "BN" else "deconv_gn",): (1, kind)}
    idx = 3
    for i in range(num_layers):
        if i >= 1 or concat:
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


_TRANS_FC = {"fc1": "fc1", "fc2": "fc2", "fc_out": "fc3"}


def _module_key(path: tuple[str, ...], rot_map: dict, pnp_map: dict) -> tuple[str, str]:
    """A flax module path of the JAX GDRN -> (the port's module name, kind)."""
    top, rest = path[0], path[1:]
    if top == "backbone":
        key, kind = _backbone_key(rest)
        return f"backbone.{key}", kind
    if top == "rot_head":
        idx, kind = rot_map[rest]
        return f"rot_head_net.features.{idx}", kind
    if top == "pnp_net":
        if len(rest) == 1:  # a Dense: ConvPnPNet's fcs, every layer of the point heads
            return f"pnp_net.{rest[0]}", "lin"
        idx, kind = pnp_map[rest]
        return f"pnp_net.features.{idx}", kind
    if top == "trans_head":
        if len(rest) == 1:
            return f"trans_head_net.{_TRANS_FC[rest[0]]}", "lin"
        i = int(rest[0][4:])  # conv<i>
        if rest[1] == "Conv_0":
            return f"trans_head_net.features.{3 * i}", "conv"
        return f"trans_head_net.features.{3 * i + 1}", "bn"
    raise KeyError(f"unmapped path: {'/'.join(path)}")


def _is_concat_head(params: dict) -> bool:
    """ROT_CONCAT: the first round's conv reads more than the deconv gives."""
    head = params.get("rot_head", {})
    try:
        return head["conv0_a"]["Conv_0"]["kernel"].shape[2] != head["deconv"]["kernel"].shape[3]
    except KeyError:
        return False


def jax_to_torch(params: dict, batch_stats: dict | None = None,
                 head_num_layers: int = 3, head_norm: str = "BN",
                 pnp_norm: str = "GN", pnp_num_layers: int = 3) -> dict[str, torch.Tensor]:
    """gdrnet_tpu GDRN (params, batch_stats) -> the port's state_dict.

    Every leaf must map to a key; an unknown path raises. BatchNorm layers
    also get `num_batches_tracked` = 0, so the result loads with strict=True."""
    rot_map = _rot_head_index(head_num_layers, head_norm, _is_concat_head(params))
    pnp_map = _pnp_index(pnp_num_layers, pnp_norm)
    conv_width = {}  # a flattening fc1's (C, H, W) needs the width of the convs before it
    out: dict[str, torch.Tensor] = {}

    def module_key(path: tuple[str, ...]) -> tuple[str, str]:
        return _module_key(path, rot_map, pnp_map)

    param_leaves = list(_leaves(params))
    for path, v in param_leaves:
        if path[0] in ("pnp_net", "trans_head") and path[-1] == "kernel" and v.ndim == 4:
            conv_width[f"{'pnp_net' if path[0] == 'pnp_net' else 'trans_head_net'}.fc1"] = \
                v.shape[-1]
    for path, v in param_leaves:
        if len(path) == 1 and path[0].startswith("log_var_"):  # the MTL log-variances
            out[path[0]] = torch.from_numpy(v.copy())
            continue
        key, kind = module_key(path[:-1])
        field = path[-1]
        if field == "kernel":
            if kind == "conv":
                w = _conv_w(v)
            elif kind == "convT":
                w = _convT_w(v)
            elif key in conv_width:
                w = _lin_w_to_chw(v, conv_width[key])
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


def _pvnet_key(path: tuple[str, ...], depth: int) -> tuple[str, str]:
    """A flax module path of the JAX PVNet -> (the port's module name, kind)."""
    trunk = f"resnet{depth}_8s"
    top = path[0]
    if top in ("conv1", "bn1"):
        return f"{trunk}.{top}", "conv" if top == "conv1" else "bn"
    if top.startswith("layer"):  # layer<s>_<b>/{conv1,bn1,conv2,bn2,downsample,downsample_bn}
        stage, block = top[5:].split("_")
        sub = {"downsample": "downsample.0", "downsample_bn": "downsample.1"}.get(path[1], path[1])
        return f"{trunk}.layer{stage}.{block}.{sub}", "bn" if "bn" in path[1] else "conv"
    if top == "head":
        return "head", "conv"
    name, _, part = top.rpartition("_")  # fc_conv, conv8s_bn, ...
    seq = f"{trunk}.fc" if name == "fc" else name
    return f"{seq}.{0 if part == 'conv' else 1}", part


def pvnet_jax_to_torch(params: dict, batch_stats: dict | None = None,
                       depth: int = 18) -> dict[str, torch.Tensor]:
    """gdrnet_tpu PVNet (params, batch_stats) -> the port's PVNet state_dict
    (models/pvnet.py's keys); BatchNorm layers also get num_batches_tracked
    = 0, so the result loads with strict=True."""
    out: dict[str, torch.Tensor] = {}
    for path, v in _leaves(params):
        key, kind = _pvnet_key(path[:-1], depth)
        if path[-1] == "kernel":
            out[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(_conv_w(v)))
        elif path[-1] in ("scale", "bias"):
            out[f"{key}.{'weight' if path[-1] == 'scale' else 'bias'}"] = torch.from_numpy(v.copy())
        else:
            raise KeyError(f"unknown param field: {'/'.join(path)}")
    for path, v in _leaves(batch_stats or {}):
        key, _ = _pvnet_key(path[:-1], depth)
        out[f"{key}.{ {'mean': 'running_mean', 'var': 'running_var'}[path[-1]]}"] = \
            torch.from_numpy(v.copy())
        out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def jax_scales_to_torch(scales: dict[str, float], head_num_layers: int = 3,
                        head_norm: str = "BN", pnp_norm: str = "GN",
                        pnp_num_layers: int = 3, rot_concat: bool = False) -> dict[str, float]:
    """The JAX package's int8 activation scales ({flax module path, e.g.
    "backbone/layer1_0/Conv_0": scale}, gdrnet_tpu/models/quantize.py) ->
    the port's ({module name, e.g. "backbone.layer1.0.conv1": scale},
    gdrnet_tpu_torch/models/quantize.py)."""
    rot_map = _rot_head_index(head_num_layers, head_norm, rot_concat)
    pnp_map = _pnp_index(pnp_num_layers, pnp_norm)
    return {_module_key(tuple(p.split("/")), rot_map, pnp_map)[0]: s for p, s in scales.items()}


def torch_scales_to_jax(scales: dict[str, float], head_num_layers: int = 3,
                        head_norm: str = "BN", pnp_norm: str = "GN",
                        pnp_num_layers: int = 3, rot_concat: bool = False) -> dict[str, float]:
    """The inverse of jax_scales_to_torch."""
    names = {f"rot_head_net.features.{i}": "rot_head/" + "/".join(p)
             for p, (i, _) in _rot_head_index(head_num_layers, head_norm, rot_concat).items()}
    names.update({f"trans_head_net.{t}": f"trans_head/{j}" for j, t in _TRANS_FC.items()})
    names.update({f"pnp_net.features.{i}": "pnp_net/" + "/".join(p)
                  for p, (i, _) in _pnp_index(pnp_num_layers, pnp_norm).items()})

    def backbone(name: str) -> str:
        parts = name.split(".")[1:]
        if len(parts) == 1:  # conv1 / bn1
            return "backbone/" + parts[0]
        layer, block, *sub = parts
        sub_name = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}.get(
            ".".join(sub))
        if sub_name is None:
            kind, k = ("Conv", sub[0][4:]) if sub[0].startswith("conv") else ("BatchNorm",
                                                                            sub[0][2:])
            sub_name = f"{kind}_{int(k) - 1}"
        return f"backbone/{layer}_{block}/{sub_name}"

    out = {}
    for name, s in scales.items():
        if name.startswith("backbone."):
            out[backbone(name)] = s
        elif name in names:
            out[names[name]] = s
        elif name.startswith("pnp_net.") and name.count(".") == 1:  # a Dense of the PnP head
            out[name.replace(".", "/")] = s
        else:
            raise KeyError(f"unmapped module: {name}")
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
