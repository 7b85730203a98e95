"""Score reporting: LaTeX tables and recall/error plots (a copy of
gdrnet_tpu/eval/report.py:28-111). matplotlib is imported inside the plot
functions, so the module imports without it; where it is missing (the GPU
machine), the plots raise ImportError.

Parity target: the reference's pysixd report utilities — latex experiment
report (lib/pysixd/latex_report.py:6-129) and evaluation plots
(lib/pysixd/eval_plots.py:372-470 plot_t_err_hist/plot_R_err_hist and the
recall-vs-error curves). Rebuilt around our in-process score dicts
(eval/bop_score.score_results output {error_type: {obj|avg: value}}) instead
of the reference's score-JSON directory scan (test_utils.py:182-343).
Matplotlib renders PNGs directly (no tikz intermediary).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

_PROLOG = r"""\documentclass[a4paper]{article}
\usepackage[a4paper,margin=2cm]{geometry}
\usepackage{graphicx}
\begin{document}
\begin{center}{\Huge Evaluation Report}\\\textbf{%s}\end{center}
"""
_EPILOG = "\n\\end{document}\n"


def _tex_escape(s: str) -> str:
    return str(s).replace("_", r"\_").replace("%", r"\%").replace("#", r"\#")


def scores_to_latex(scores: dict, caption: str = "scores") -> str:
    """{error_type: {obj_name|'avg': recall}} -> a latex tabular (objects as
    columns, error types as rows; values in %% like the reference tables,
    test_utils.py:182-343)."""
    objs = sorted({o for per in scores.values() for o in per if o != "avg"})
    cols = objs + ["avg"]
    lines = [r"\begin{table}[h]", r"\centering",
             r"\caption{%s}" % _tex_escape(caption),
             r"\begin{tabular}{l%s}" % ("r" * len(cols)), r"\hline",
             " & ".join(["error"] + [_tex_escape(c) for c in cols])
             + r" \\", r"\hline"]
    for etype, per in scores.items():
        cells = [_tex_escape(etype)]
        for c in cols:
            v = per.get(c)
            cells.append("-" if v is None else f"{100 * float(np.mean(v)):.2f}")
        lines.append(" & ".join(cells) + r" \\")
    lines += [r"\hline", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def write_latex_report(path: str, scores: dict, title: str = "gdrnet_tpu",
                       extra_tables: list[tuple[str, dict]] | None = None,
                       figures: list[str] | None = None) -> str:
    """Standalone compilable .tex with the score table(s) and optional figure
    includes (latex_report.py Report.save semantics: one document per eval)."""
    parts = [_PROLOG % _tex_escape(title), scores_to_latex(scores, title)]
    for cap, sc in (extra_tables or []):
        parts.append(scores_to_latex(sc, cap))
    for fig in (figures or []):
        parts.append(r"\begin{figure}[h]\centering"
                     + r"\includegraphics[width=0.8\textwidth]{%s}" % fig
                     + r"\end{figure}")
    parts.append(_EPILOG)
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    tex = "\n".join(parts)
    with open(path, "w") as f:
        f.write(tex)
    return tex


def plot_t_err_recall(t_errors_m: np.ndarray, out_png: str) -> None:
    """Recall vs per-axis |translation error| curves
    (eval_plots.plot_t_err_hist, eval_plots.py:372-395), mm on the x axis."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.abs(np.asarray(t_errors_m, np.float64)) * 1000.0
    recall = (np.arange(len(t)) + 1.0) / max(len(t), 1)
    fig, ax = plt.subplots()
    for i, lab in enumerate(["cum x error", "cum y error", "cum z error"]):
        ax.plot(np.sort(t[:, i]), recall, label=lab)
    ax.set_title("Recall vs Translation Error")
    ax.set_xlabel("translation err [mm]")
    ax.set_ylabel("recall")
    ax.grid(True)
    ax.legend()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)


def plot_err_hist(errors: np.ndarray, out_png: str, bins: int = 15,
                  max_val: float | None = None,
                  xlabel: str = "error") -> None:
    """Error histogram (eval_plots.plot_t_err_hist2/plot_R_err_hist2,
    eval_plots.py:398-470)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    e = np.asarray(errors, np.float64).reshape(-1)
    hi = float(max_val if max_val is not None else (e.max() if e.size else 1.0))
    fig, ax = plt.subplots()
    ax.hist(e, bins=np.linspace(0, max(hi, 1e-9), bins + 1))
    ax.set_xlabel(xlabel)
    ax.set_ylabel("views")
    ax.set_title(f"{xlabel} histogram")
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
