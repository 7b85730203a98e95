"""Minimal PLY mesh loader (ASCII + binary little/big endian); a copy of
gdrnet_tpu/data/ply.py, which cannot be imported without JAX.

Replaces the reference's inout.load_ply (lib/pysixd/inout.py:493) for BOP
model meshes: returns {"pts": [N,3] float32, "normals": optional,
"colors": optional, "faces": [M,3] int32}. Written against the PLY spec, not
the reference implementation.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str, vertex_scale: float = 1.0) -> dict:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", f"not a PLY file: {path}"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ("list", idx_t, val_t, name)])
        cur = None
        while True:
            raw = f.readline()
            if not raw:  # EOF before end_header: truncated/corrupt file
                raise ValueError(f"PLY header never terminated: {path}")
            line = raw.decode("ascii").strip()
            if line.startswith("comment") or not line:
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[2], parts[1]))
            elif line == "end_header":
                break

        out: dict = {}
        if fmt == "ascii":
            tokens = f.read().decode("ascii").split()
            pos = 0
            for name, cnt, props in elements:
                if name == "vertex":
                    width = len(props)
                    arr = np.asarray(tokens[pos:pos + cnt * width], np.float64).reshape(cnt, width)
                    pos += cnt * width
                    _fill_vertex(out, arr, [p[0] for p in props])
                elif name == "face":
                    faces = []
                    for _ in range(cnt):
                        k = int(tokens[pos]); pos += 1
                        faces.append([int(t) for t in tokens[pos:pos + k]]); pos += k
                    out["faces"] = np.asarray(faces, np.int32)
                else:
                    for _ in range(cnt):
                        k = int(tokens[pos]); pos += 1 + k
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            for name, cnt, props in elements:
                if name == "vertex":
                    dt = np.dtype([(p[0], endian + _DTYPES[p[1]]) for p in props])
                    rec = np.frombuffer(f.read(dt.itemsize * cnt), dtype=dt)
                    arr = np.stack([rec[p[0]].astype(np.float64) for p in props], axis=1)
                    _fill_vertex(out, arr, [p[0] for p in props])
                elif name == "face":
                    # assume uniform triangle lists (BOP meshes are)
                    faces = []
                    idx_t, val_t = props[0][1], props[0][2]
                    it = np.dtype(endian + _DTYPES[idx_t])
                    vt = np.dtype(endian + _DTYPES[val_t])
                    for _ in range(cnt):
                        k = int(np.frombuffer(f.read(it.itemsize), it)[0])
                        faces.append(np.frombuffer(f.read(vt.itemsize * k), vt)[:3])
                    out["faces"] = np.asarray(faces, np.int32)

    out["pts"] = (out["pts"] * vertex_scale).astype(np.float32)
    return out


def _fill_vertex(out: dict, arr: np.ndarray, names: list[str]) -> None:
    idx = {n: i for i, n in enumerate(names)}
    out["pts"] = arr[:, [idx["x"], idx["y"], idx["z"]]]
    if "nx" in idx:
        out["normals"] = arr[:, [idx["nx"], idx["ny"], idx["nz"]]].astype(np.float32)
    if "red" in idx:
        out["colors"] = arr[:, [idx["red"], idx["green"], idx["blue"]]].astype(np.uint8)


def save_ply(path: str, pts: np.ndarray, faces: np.ndarray | None = None,
             colors: np.ndarray | None = None) -> None:
    """ASCII PLY writer (fixtures/tools)."""
    pts = np.asarray(pts)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
             "property float x", "property float y", "property float z"]
    if colors is not None:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        lines += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    lines.append("end_header")
    for i, p in enumerate(pts):
        row = f"{p[0]} {p[1]} {p[2]}"
        if colors is not None:
            c = colors[i]
            row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
        lines.append(row)
    if faces is not None:
        for fc in faces:
            lines.append("3 " + " ".join(str(int(v)) for v in fc))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
