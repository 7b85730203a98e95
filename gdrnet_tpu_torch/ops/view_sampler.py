"""Viewpoint sampling on a sphere, the port's copy of
gdrnet_tpu/ops/view_sampler.py (reference lib/pysixd/view_sampler.py:
hinterstoisser-style recursive icosahedron subdivision + in-plane rotations;
used by render-based pipelines to cover SO(3)). Provides both the icosphere
sampler and a cheap Fibonacci-sphere alternative.
"""

from __future__ import annotations

import numpy as np


def fibonacci_sphere_views(n: int, radius: float = 1.0) -> np.ndarray:
    """[n, 3] near-uniform points on a sphere (golden-angle spiral)."""
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1 - 2 * (i + 0.5) / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([
        np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)
    ], axis=1).astype(np.float32)


def icosphere_views(min_n_views: int, radius: float = 1.0) -> np.ndarray:
    """Recursively subdivided icosahedron vertices (the reference sampler's
    view positions, view_sampler.sample_views) with >= min_n_views points."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

    verts = [v / np.linalg.norm(v) for v in verts]
    while len(verts) < min_n_views:
        cache: dict = {}
        new_faces = []
        for f in faces:
            mids = []
            for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
                key = (min(a, b), max(a, b))
                if key not in cache:
                    m = (verts[a] + verts[b]) / 2.0
                    verts.append(m / np.linalg.norm(m))
                    cache[key] = len(verts) - 1
                mids.append(cache[key])
            m0, m1, m2 = mids
            new_faces += [[f[0], m0, m2], [f[1], m1, m0],
                          [f[2], m2, m1], [m0, m1, m2]]
        faces = np.asarray(new_faces)
    return (np.asarray(verts) * radius).astype(np.float32)


def view_to_pose(view_pt: np.ndarray, up=(0.0, 0.0, 1.0)) -> tuple[np.ndarray, np.ndarray]:
    """Camera looking at the origin from view_pt -> (R, t) world->cam
    (view_sampler camera orientation convention: -z toward origin)."""
    view_pt = np.asarray(view_pt, np.float64)
    f = -view_pt / np.linalg.norm(view_pt)  # camera forward (+z in cam)
    up = np.asarray(up, np.float64)
    if abs(np.dot(f, up)) > 0.999:
        up = np.array([1.0, 0.0, 0.0])
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    R = np.stack([s, -u, f], axis=0)  # rows: right, down, forward
    t = -R @ view_pt
    return R.astype(np.float32), t.astype(np.float32)


def sample_views(min_n_views: int, radius: float = 1.0,
                 mode: str = "icosphere") -> list[dict]:
    """[{R, t}] camera poses covering the sphere (reference
    view_sampler.sample_views return shape)."""
    pts = (icosphere_views(min_n_views, radius) if mode == "icosphere"
           else fibonacci_sphere_views(min_n_views, radius))
    out = []
    for p in pts:
        R, t = view_to_pose(p)
        out.append({"R": R, "t": t})
    return out
