"""Evaluation: pose errors, the in-process evaluator, BOP19 scoring and its
CSV, VSD, pose matching and reports (exports as gdrnet_tpu/eval/__init__.py)."""

from gdrnet_tpu_torch.eval import pose_errors
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results, save_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import CustomEvaluator
from gdrnet_tpu_torch.eval.report import scores_to_latex, write_latex_report

__all__ = ["pose_errors", "save_bop_results", "load_bop_results",
           "CustomEvaluator", "scores_to_latex", "write_latex_report"]
