"""The layered python-file config system and the default config tree: a copy
of gdrnet_tpu/config (config.py, defaults.py), which imports only the
standard library, kept in the port so that the port imports nothing of the
JAX package. tests/test_torch_slice.py holds the merged configs of every
file under configs/ equal to the JAX package's.
"""

from gdrnet_tpu_torch.config.config import Config, load_config, merge_dict
from gdrnet_tpu_torch.config.defaults import base_config

__all__ = ["Config", "base_config", "load_config", "merge_dict"]
