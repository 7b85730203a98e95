"""Offline tools of the port, run as `python -m gdrnet_tpu_torch.tools.<name>`:
bench_pnp, compute_fps, eval_csv, gen_scale_dataset, gen_xyz and predict
(the counterparts of the repository's tools/*.py)."""

__all__ = ["bench_pnp", "compute_fps", "eval_csv", "gen_scale_dataset", "gen_xyz", "predict"]
