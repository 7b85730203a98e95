"""BOP19 result CSV I/O (a copy of gdrnet_tpu/eval/bop_writer.py) —
format-compatible with the original BOP toolkit so its scorer can
cross-check the in-process metrics.

Format (reference lib/pysixd/inout.py:304-376 save/load_bop_results,
test_utils.py:37-52 to_bop_csv): one line per estimate,
`scene_id,im_id,obj_id,score,R,t,time` with R row-major space-separated
9 floats and t in millimetres.
"""

from __future__ import annotations

import os

import numpy as np


def save_bop_results(path: str, results: list[dict], version: str = "bop19") -> None:
    """results: list of {scene_id, im_id, obj_id, score, R [3,3], t [3] (mm),
    time}."""
    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for res in results:
        R = np.asarray(res["R"], np.float64).reshape(9)
        t = np.asarray(res["t"], np.float64).reshape(3)
        lines.append(
            "{scene_id},{im_id},{obj_id},{score},{R},{t},{time}".format(
                scene_id=int(res["scene_id"]),
                im_id=int(res["im_id"]),
                obj_id=int(res["obj_id"]),
                score=float(res.get("score", 1.0)),
                R=" ".join(f"{v:.8f}" for v in R),
                t=" ".join(f"{v:.8f}" for v in t),
                time=float(res.get("time", -1.0)),
            )
        )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_bop_results(path: str) -> list[dict]:
    results = []
    with open(path) as f:
        header = f.readline().strip()
        assert header.startswith("scene_id"), f"bad BOP csv header: {header}"
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            results.append({
                "scene_id": int(parts[0]),
                "im_id": int(parts[1]),
                "obj_id": int(parts[2]),
                "score": float(parts[3]),
                "R": np.asarray(parts[4].split(), np.float64).reshape(3, 3),
                "t": np.asarray(parts[5].split(), np.float64),
                "time": float(parts[6]) if len(parts) > 6 else -1.0,
            })
    return results
