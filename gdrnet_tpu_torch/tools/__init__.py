"""Offline tools of the port, run as `python -m gdrnet_tpu_torch.tools.<name>`."""
