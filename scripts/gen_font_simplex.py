#!/usr/bin/env python3
"""Writes gdrnet_tpu_torch/data/font_simplex.py, the glyph table of
cv_ops.put_text, from OpenCV's own rendering (needs cv2; the package never
imports it).

OpenCV 5.0 draws FONT_HERSHEY_SIMPLEX as antialiased glyphs, one after the
other, each at an integer pen position. For every printable ASCII character
this renders the character alone with cv2.putText (scale 0.5, thickness 1,
white on black), keeps the box of its non-zero pixels (the coverage mask,
0-255) with the box's offset from the text origin, and takes the advance
as getTextSize's width less 1 (a string's width is the sum of its advances
plus 1).

Run:  python3 scripts/gen_font_simplex.py   (tests/test_torch_vis.py checks
that the committed table equals a fresh one)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SCALE, THICKNESS = 0.5, 1
OUT = Path(__file__).resolve().parents[1] / "gdrnet_tpu_torch" / "data" / "font_simplex.py"
HEADER = '''"""The glyph table of data/cv_ops.put_text: cv2.putText's FONT_HERSHEY_SIMPLEX
at scale 0.5, thickness 1, as OpenCV 5.0 renders it. Written by
scripts/gen_font_simplex.py; do not edit.

GLYPHS[ch] = (advance, dx, dy, width, height, coverage): the pen moves by
`advance` after the character; its coverage mask (0-255, row-major hex,
`height` rows of `width`) has its top-left pixel at (org.x + dx, org.y + dy)
from the pen position `org` (the text's bottom-left).
"""

SCALE, THICKNESS = {scale}, {thickness}

GLYPHS = {{
'''


def glyph_table() -> dict:
    import cv2

    table = {}
    ox, oy = 32, 48
    for code in range(32, 127):
        ch = chr(code)
        img = np.zeros((96, 96), np.uint8)
        cv2.putText(img, ch, (ox, oy), cv2.FONT_HERSHEY_SIMPLEX, SCALE, 255, THICKNESS)
        advance = cv2.getTextSize(ch, cv2.FONT_HERSHEY_SIMPLEX, SCALE, THICKNESS)[0][0] - 1
        ys, xs = np.nonzero(img)
        if len(ys) == 0:
            table[ch] = (advance, 0, 0, 0, 0, "")
            continue
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        table[ch] = (int(advance), int(x0 - ox), int(y0 - oy), int(x1 - x0), int(y1 - y0),
                     img[y0:y1, x0:x1].tobytes().hex())
    return table


def module_source(table: dict) -> str:
    lines = [HEADER.format(scale=SCALE, thickness=THICKNESS)]
    for ch, (adv, dx, dy, w, h, cov) in table.items():
        rows = [repr(cov[i:i + 64]) for i in range(0, len(cov), 64)] or ["''"]
        lines.append(f"    {ch!r}: ({adv}, {dx}, {dy}, {w}, {h},\n"
                     f"          " + "\n          ".join(rows) + "),\n")
    lines.append("}\n")
    return "".join(lines)


if __name__ == "__main__":
    OUT.write_text(module_source(glyph_table()))
    print(f"wrote {OUT}")
