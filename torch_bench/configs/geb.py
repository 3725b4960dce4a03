"""Plain reference of the GEB sculpture of the ui-geb viewer (soypat/gsdf
examples/ui-geb/uigeb.go:22-89): the glyphs G, E and B at relative
tolerance 0.01, each centred and offset by -0.01, extruded to the largest
glyph size, scaled to a square section and offset by -0.025; G ^ E turned
90 deg about y ^ B turned -90 deg about x, beside E ^ G ^ B the same way,
moved up by 1.5 times its height; the two joined, scaled by 0.3. Built
from the recipe alone.

The font is data, like a model's weights: the TTF the program ships, read
by the path that `geb.json` gives (`font`), relative to the repository's
root. Upstream embeds iso-3098.ttf; the configuration assumes the DejaVu
Sans ASCII subset in its place (`assumed`). The glyph and node
departures are in `torch_bench/reference/text.py`.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from torch_bench.reference import sdf, text

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

ORIGINAL: dict = {}


def font_path() -> str:
    with open(os.path.join(HERE, "geb.json")) as f:
        return os.path.join(ROOT, json.load(f)["font"])


def _size(node):
    lo, hi = node.bounds()
    return (hi - lo).astype(np.float32)


def _centred(node):
    lo, _ = node.bounds()
    sz = _size(node)
    return sdf.Translate(node, [-float(lo[0]) - sz[0] / 2, -float(lo[1]) - sz[1] / 2])


def part(values=None):
    if values:
        raise ValueError(f"the GEB sculpture has no editable dimension, got {sorted(values)}")
    font = font_path()
    g, e, b = (text.glyph(font, c, 0.01) for c in "GEB")
    sizes = [_size(n) for n in (g, e, b)]
    szz = float(max(s.max() for s in sizes))
    solids = []
    for node, sz in zip((g, e, b), sizes):
        flat = text.Offset(_centred(node), -0.01)
        solid = text.Transform(text.Extrude(flat, szz), text.scaling(szz / sz[0], szz / sz[1], 1))
        solids.append(text.Offset(solid, -0.025))
    g3, e3, b3 = solids
    deg90 = math.pi / 2
    geb1 = sdf.Intersection(sdf.Intersection(g3, text.Rotate(e3, deg90, (0, 1, 0))),
                            text.Rotate(b3, -deg90, (1, 0, 0)))
    geb2 = sdf.Intersection(sdf.Intersection(e3, text.Rotate(g3, deg90, (0, 1, 0))),
                            text.Rotate(b3, -deg90, (1, 0, 0)))
    geb2 = sdf.Translate(geb2, [0, float(_size(geb2)[1]) * 1.5, 0])
    return sdf.Scale(sdf.Union([geb1, geb2]), 0.3)
