"""Head-output decoding (counterpart of gdrnet_tpu/engine/decode.py; the
reference's engine_utils.py:92-126 get_out_coor / get_out_mask): binned-CE
xyz channels -> continuous [0, 1] coordinates by the argmax bin, mask
logits -> a probability.

Layout: channels-last, as the port's model returns its maps
(models/gdrn.GDRN.forward: "mask" [B, H, W, C], "coor_x" [B, H, W, 1] or
[B, H, W, bin + 1]). The decode runs in f32 on the maps' device.
"""

from __future__ import annotations

import torch


def get_out_coor(coor_x: torch.Tensor, coor_y: torch.Tensor, coor_z: torch.Tensor,
                 xyz_bin: int = 64, decode_type: str = "center") -> torch.Tensor:
    """[B,H,W,1] (L1 mode) or [B,H,W,bin+1] (CE mode, the last bin is the
    background) per channel -> [B,H,W,3] coordinates in [0, 1]
    (engine_utils.get_out_coor:92-105: the argmax over the object bins,
    pixels whose argmax over all bins is the background zeroed).

    decode_type "center" gives (idx + 0.5) / bin, the unbiased decode of the
    floor(x * bin) encoding of models trained in this repository;
    "reference" gives idx / (bin - 1), as engine_utils.py:103, for the
    reference's checkpoints trained in CE mode (TEST.CE_DECODE_TYPE)."""
    if decode_type not in ("center", "reference"):
        raise ValueError(f"unknown CE decode type: {decode_type}")
    outs = []
    for c in (coor_x, coor_y, coor_z):
        c = c.float()
        if c.shape[-1] == 1:
            outs.append(c[..., 0])
            continue
        idx = c[..., :-1].argmax(-1).float()
        is_fg = c.argmax(-1) < c.shape[-1] - 1
        dec = (idx + 0.5) / xyz_bin if decode_type == "center" else idx / (xyz_bin - 1)
        outs.append(torch.where(is_fg, dec, torch.zeros_like(dec)))
    return torch.stack(outs, dim=-1)


def get_out_mask(mask: torch.Tensor, mask_loss_type: str = "L1") -> torch.Tensor:
    """[B,H,W,C] mask head channels -> [B,H,W] probability
    (engine_utils.get_out_mask:108-126)."""
    mask = mask.float()
    if mask_loss_type == "CE":
        # the hard argmax class, as the reference (engine_utils.py:123): a
        # softmax probability selects another foreground at MASK_THR_TEST != 0.5
        return mask.argmax(-1).float()
    if mask_loss_type == "BCE":
        return torch.sigmoid(mask[..., 0])
    # L1: min-max normalised to [0, 1] per image (engine_utils.py:115-117)
    m = mask[..., 0]
    lo = m.amin(dim=(1, 2), keepdim=True)
    hi = m.amax(dim=(1, 2), keepdim=True)
    return (m - lo) / (hi - lo).clamp_min(1e-6)
