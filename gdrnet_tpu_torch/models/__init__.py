"""The port's models: GDRN with every variant of MODEL.CDPN (models/gdrn.py)
and the PVNet-style dense net (models/pvnet.py)."""

from gdrnet_tpu_torch.models.gdrn import GDRN, build_model
from gdrnet_tpu_torch.models.pvnet import PVNet

__all__ = ["GDRN", "PVNet", "build_model"]
