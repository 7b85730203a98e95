"""Offline tools of the port, run as `python -m gdrnet_tpu_torch.tools.<name>`:
bench (serving crops/s), bench_pnp, bench_train (the train step, the
loader and the FLOP audit), compute_fps, dryrun_multichip, eval_csv,
export_model (torch.export of the serving forward), gen_det_fuse,
gen_scale_dataset, gen_test_targets, gen_xyz, predict, scale_run (the scale
run's resumable stages), strip_ckpt, validate_overfit and validate_scale
(the learning checks) (the counterparts of the repository's bench.py and
tools/*.py)."""

from __future__ import annotations

import torch

__all__ = ["bench", "bench_pnp", "bench_train", "compute_fps", "dryrun_multichip", "eval_csv",
           "export_model", "gen_det_fuse", "gen_scale_dataset", "gen_test_targets", "gen_xyz",
           "predict", "scale_run", "strip_ckpt", "validate_overfit", "validate_scale"]


class NoCardError(SystemExit, RuntimeError):
    """A tool was asked for the card where there is none: the process exits
    with the message, as a SystemExit does; a caller may catch it as a
    RuntimeError."""


def entry_device(tool: str, device) -> torch.device:
    """The device a tool runs on; raises NoCardError, whose message names
    --device cpu, when it is a CUDA device and no card is available. `tool`
    is a module of tools/, or a dotted path under the package (a CLI
    elsewhere, such as data.visualize)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        module = tool if "." in tool else f"tools.{tool}"
        raise NoCardError(f"gdrnet_tpu_torch.{module}: no CUDA card is available "
                          "(torch.cuda.is_available() is false); pass --device cpu")
    return device
