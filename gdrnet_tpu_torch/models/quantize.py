"""Post-training int8 quantization for serving (counterpart of
gdrnet_tpu/models/quantize.py:45-231, with its recipe).

Every calibrated Conv2d / Linear of a quantized copy of the model runs as:

    x_i8 = clip(round(x / s_x), -127, 127)     s_x: one scale a layer, max|x| / 127
                                                from calibration batches
    w_i8 = clip(round(w / s_w[c]), -127, 127)  s_w: per output channel,
                                                max(max|w[c]| / 127, 1e-12)
    y    = int32-accumulated product of x_i8 and w_i8, in f32 times
           (s_x * s_w[c]), plus the bias; cast back to x's dtype

Symmetric, so no zero-point terms; the int32 sum is exact, and the only
error is the 8-bit rounding of the inputs and the weights.

Which layers, as the JAX package's recipe (quantize.py:60-66): the convs
under `backbone` and `rot_head_net` and the linears under `backbone`,
`rot_head_net`, `pnp_net` and `trans_head_net` (pnp_net.fc1 and fc2,
TransHeadNet's fc1 and fc2), but never the head's f32 out conv (the last of
rot_head_net.features, the JAX package's `out_conv`), the pose regressors
fc_r / fc_t / fc_pose and TransHeadNet's fc3 (JAX's `fc_out`), nor the point
heads' MLP layers (linears named conv1-3, conv_topk, conv_sp), which read
the decoded coordinate maps as ConvPnPNet's convs do, which stay off too;
the head's ConvTranspose2d is not an nn.Conv in the JAX package, so neither
quantizes it.

The int8 product, by device: on CUDA, im2col of the int8 input in NHWC (a
strided view, copied) and `torch._int_mm` (cuBLASLt's int8 tensor-core
GEMM, as the JAX package leaves the product to XLA's `conv_general_dilated`
with preferred_element_type=int32), with the matrices' rows, depth and
columns padded with zeros to the shapes it takes and the batch split into
chunks of at most `IM2COL_BYTES`; its NHWC result stays NHWC in memory (a
channels_last NCHW view), so that the next int8 layer's im2col reads each
pixel's channels as one run, and the BN, ReLU and upsample between run on
channels_last tensors. On the CPU, the plain version: the same int8 values
in float64 `F.conv2d` / `F.linear`, exact since |sum| <= 127^2 * K < 2^53.
An int8 layer on a CUDA tensor runs the int8 GEMM or raises. An int8
layer's output takes the dtype the float layer's would have: autocast's
where it is on, else its input's.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_CONV_PREFIXES = ("backbone", "rot_head_net")
DEFAULT_LINEAR_PREFIXES = ("backbone", "rot_head_net", "pnp_net", "trans_head_net")
DEFAULT_EXCLUDE_NAMES = ("fc_r", "fc_t", "fc_pose")
LINEAR_EXTRA_EXCLUDE_NAMES = ("conv1", "conv2", "conv3", "conv_topk", "conv_sp")
IM2COL_BYTES = 1 << 30      # the int8 im2col of one chunk of the batch
_MIN_ROWS = 32              # _int_mm takes more than 16 rows


def quantizable_layers(model: nn.Module) -> dict[str, nn.Module]:
    """{name: module} of the layers the int8 recipe covers (module docstring)."""
    never = {"rot_head_net.features." + str(len(model.rot_head_net.features) - 1),
             "trans_head_net.fc3"} if hasattr(model, "rot_head_net") else set()
    layers = {}
    for name, m in model.named_modules():
        parts = name.split(".")
        if name in never or any(s in DEFAULT_EXCLUDE_NAMES for s in parts):
            continue
        if isinstance(m, nn.Conv2d) and name.startswith(DEFAULT_CONV_PREFIXES):
            layers[name] = m
        elif (isinstance(m, nn.Linear) and name.startswith(DEFAULT_LINEAR_PREFIXES)
              and parts[-1] not in LINEAR_EXTRA_EXCLUDE_NAMES):
            layers[name] = m
    return layers


def calibrate_act_scales(model: nn.Module, batches: list[dict]) -> dict[str, float]:
    """{layer name: max|input| / 127} over the forwards of `batches` (dicts
    of the predict step's inputs, arrays or tensors) through `model` as the
    predict step runs it; a layer called twice in a forward keeps the max of
    both calls, and a layer whose max is 0 gets no scale."""
    from gdrnet_tpu_torch.engine.steps import _autocast, _model_kwargs

    device = next(model.parameters()).device
    maxes: dict[str, torch.Tensor] = {}

    def hook(name):
        def record(_module, args):
            m = args[0].detach().abs().amax().float()
            maxes[name] = torch.maximum(maxes[name], m) if name in maxes else m
        return record

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in quantizable_layers(model).items()]
    was_training = model.training
    model.eval()
    try:
        for b in batches:
            b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            with torch.inference_mode(), _autocast(model, device):
                model(b["roi_img"], **_model_kwargs(b))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return {name: m / 127.0 for name, m in ((n, float(v.item())) for n, v in maxes.items())
            if m > 0}


def _quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_i8, s_w) per output channel (dim 0), in f32 on the CPU, as the JAX
    package computes them."""
    w = w.detach().float().cpu()
    sw = torch.clamp(w.abs().amax(dim=tuple(range(1, w.ndim))) / 127.0, min=1e-12)
    w_i8 = torch.clamp(torch.round(w / sw.reshape((-1,) + (1,) * (w.ndim - 1))), -127, 127)
    return w_i8.to(torch.int8), sw


def quantize_input(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s_x)) as int8; s_x a 0-d f32 tensor on x's device (a
    tensor, so that the division is a true f32 division on every device)."""
    return torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int32 [M, N] = a [M, K] int8 @ b_t.T, b_t [N, K] int8, both on CUDA:
    torch._int_mm with M padded to at least _MIN_ROWS and K, N to multiples
    of 8 with zeros (which keeps the sums exact)."""
    if a.device.type != "cuda" or b_t.device != a.device:
        raise ValueError(f"int8_matmul: CUDA tensors only, got {a.device} and {b_t.device}")
    m, k = a.shape
    n = b_t.shape[0]
    mp, kp, np_ = max(_ceil(m, 8), _MIN_ROWS), _ceil(k, 8), _ceil(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    int8_matmul.launches += 1
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n]


int8_matmul.launches = 0


def _im2col_nhwc(x: torch.Tensor, kh: int, kw: int, stride, padding, dilation) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B * Ho * Wo, kh * kw * C]: columns in (kh, kw,
    C) order, each pixel's C values one contiguous run of the input (a
    strided view, then one copy)."""
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    x = F.pad(x, (0, 0, pw, pw, ph, ph))
    cols = x.unfold(1, (kh - 1) * dh + 1, sh).unfold(2, (kw - 1) * dw + 1, sw)
    cols = cols[..., ::dh, ::dw]  # [B, Ho, Wo, C, kh, kw]
    b, ho, wo, c = cols.shape[:4]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, kh * kw * c)


def int8_conv2d(x_i8: torch.Tensor, w_i8: torch.Tensor, stride=(1, 1), padding=(0, 0),
                dilation=(1, 1)) -> torch.Tensor:
    """int32 conv of int8 x_i8 [B, C, H, W] with int8 w_i8 [O, C, kh, kw].
    On CUDA: the input taken as NHWC (a free view when x_i8 is
    channels_last, as the int8 layers keep their activations), im2col and
    int8_matmul in chunks of the batch, and the result an NCHW view of the
    NHWC product (channels_last). On the CPU the plain version: float64
    F.conv2d, exact, NCHW."""
    if x_i8.device.type == "cpu":
        return F.conv2d(x_i8.double(), w_i8.double(), None, stride, padding,
                        dilation).to(torch.int32)
    o, c, kh, kw = w_i8.shape
    w_mat = w_i8.permute(0, 2, 3, 1).reshape(o, kh * kw * c)  # the columns' (kh, kw, C)
    b, _, h, w = x_i8.shape
    ho = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    x_nhwc = x_i8.permute(0, 2, 3, 1)
    per = max(1, IM2COL_BYTES // max(1, ho * wo * c * kh * kw))
    outs = [int8_matmul(_im2col_nhwc(x_nhwc[s:s + per], kh, kw, stride, padding, dilation),
                        w_mat) for s in range(0, b, per)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def int8_linear(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """int32 [..., O] of int8 x_i8 [..., I] and w_i8 [O, I]: int8_matmul on
    CUDA, float64 F.linear (exact) on the CPU."""
    if x_i8.device.type == "cpu":
        return F.linear(x_i8.double(), w_i8.double()).to(torch.int32)
    lead = x_i8.shape[:-1]
    return int8_matmul(x_i8.reshape(-1, x_i8.shape[-1]), w_i8).reshape(*lead, w_i8.shape[0])


class _Int8Layer(nn.Module):
    def __init__(self, layer: nn.Module, act_scale: float):
        super().__init__()
        w_i8, sw = _quantize_weight(layer.weight)
        dev = layer.weight.device
        self.register_buffer("w_i8", w_i8.to(dev))
        self.register_buffer("w_scale", sw.to(dev))
        self.register_buffer("act_scale", torch.tensor(act_scale, dtype=torch.float32,
                                                       device=dev))
        self.register_buffer("bias", None if layer.bias is None
                             else layer.bias.detach().float().clone())

    def _finish(self, acc: torch.Tensor, x: torch.Tensor, shape) -> torch.Tensor:
        """acc in f32 times (s_x * s_w), plus the bias, in the dtype the float
        layer would have given: autocast's where it is on (the JAX package's
        next bf16 module casts to it), else x's."""
        y = acc.float() * (self.act_scale * self.w_scale).reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        dev = x.device.type
        return y.to(torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev)
                    else x.dtype)


class Int8Conv2d(_Int8Layer):
    """A calibrated Conv2d on the int8 path (groups 1)."""

    def __init__(self, conv: nn.Conv2d, act_scale: float):
        if conv.groups != 1 or conv.padding_mode != "zeros":
            raise NotImplementedError("Int8Conv2d: groups=1 and zero padding only")
        super().__init__(conv, act_scale)
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = int8_conv2d(quantize_input(x, self.act_scale), self.w_i8, self.stride,
                          self.padding, self.dilation)
        return self._finish(acc, x, (1, -1, 1, 1))


class Int8Linear(_Int8Layer):
    """A calibrated Linear on the int8 path."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = int8_linear(quantize_input(x, self.act_scale), self.w_i8)
        return self._finish(acc, x, (-1,))


def quantize_model(model: nn.Module, scales: dict[str, float]) -> nn.Module:
    """A deep copy of `model` in eval mode in which every quantizable layer
    with a scale in `scales` is an Int8Conv2d / Int8Linear; `model` is left
    as it was."""
    q = copy.deepcopy(model).eval()
    for name, layer in quantizable_layers(q).items():
        if name not in scales:
            continue
        parent_name, _, attr = name.rpartition(".")
        parent = q.get_submodule(parent_name) if parent_name else q
        cls = Int8Conv2d if isinstance(layer, nn.Conv2d) else Int8Linear
        setattr(parent, attr, cls(layer, scales[name]))
    return q
