"""TTF text -> 2D SDF (reference forge/textsdf/font.go; the port of
gsdf_tpu/forge/textsdf/font.py, with the same arguments, defaults, errors
and float32 vertices).

The port reads the font itself (`sfnt.TrueType`: TrueType glyf outlines,
in the standard library, so it needs no font package; the JAX package
reads it with fontTools): each glyph reaches the flattening as the same
pen calls with the same points as fontTools draws it. Glyph contours are
flattened by adaptive bezier bisection (the Spline3Sampler.SampleBisect
role, font.go:286-291,311), converted to winding-number polygons, and
holes are subtracted by contour winding sign (font.go:244-255).
Coordinates are scaled so the font's global bbox minor dimension is 1
(font.go:208-212). TrueType outlines are y-up already, so the
reference's y negation (font.go:332) is not needed.

The default font is the port's own vendored ASCII subset of DejaVu Sans
(vendored/DejaVuSans-ascii.ttf + LICENSE-DejaVu.txt, Bitstream Vera
license), byte for byte the JAX package's; the reference embeds an
ISO-3098 technical font (embed.go:8-16). Any TTF may be loaded with
`load_ttf_bytes` or `load_ttf_file`.

Spans (`gsdf_tpu_torch.spans`): `textsdf.load`, the TTF parse;
`textsdf.glyph`, one per glyph built (flattening and polygons). `COUNTS`
adds the glyphs, contours and polygon vertices built.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ... import spans
from ...core import Builder
from .sfnt import TrueType

_f32 = np.float32

FIRST_BASIC = ord("!")
LAST_BASIC = ord("~")

#: the embedded default font, so text renders alike on every host
EMBEDDED_FONT_PATH = os.path.join(os.path.dirname(__file__), "vendored", "DejaVuSans-ascii.ttf")

# system fonts tried only if the vendored file is missing (stripped
# install); full-unicode use should load_ttf_file an explicit font
DEFAULT_FONT_PATHS = [
    EMBEDDED_FONT_PATH,
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
]

#: glyphs, contours and polygon vertices built, since the process started
COUNTS = {"glyphs": 0, "contours": 0, "vertices": 0}


def _default_font_bytes() -> bytes:
    for p in DEFAULT_FONT_PATHS:
        if os.path.exists(p):
            with open(p, "rb") as f:
                return f.read()
    # fall back to matplotlib's bundled DejaVu
    try:
        import matplotlib

        p = os.path.join(matplotlib.get_data_path(), "fonts", "ttf", "DejaVuSans.ttf")
        with open(p, "rb") as f:
            return f.read()
    except Exception as e:  # pragma: no cover
        raise FileNotFoundError("no default TTF font found") from e


class FontConfig:
    """(reference font.go:21-25)."""

    def __init__(self, relative_glyph_tolerance: float = 0.0, builder=None):
        self.relative_glyph_tolerance = relative_glyph_tolerance
        self.builder = builder


class Font:
    """Font parsing and glyph SDF generation (reference font.go:28-37)."""

    def __init__(self, builder=None):
        self._ttf = None
        self._glyphset = None
        self._cmap = None
        self._units_per_em = 1000
        self._basic: Dict[int, object] = {}
        self._other: Dict[str, object] = {}
        self.bld = builder or Builder()
        self.reltol = 0.15

    # --- configuration / loading ------------------------------------
    def configure(self, cfg: FontConfig) -> None:
        if cfg.relative_glyph_tolerance < 0 or cfg.relative_glyph_tolerance >= 1:
            raise ValueError("invalid relative_glyph_tolerance")
        self._reset()
        if cfg.relative_glyph_tolerance:
            self.reltol = cfg.relative_glyph_tolerance
        if cfg.builder is not None:
            self.bld = cfg.builder

    def load_ttf_bytes(self, ttf: bytes) -> None:
        with spans.span("textsdf.load"):
            self._ttf = self._glyphset = TrueType(ttf)
            self._cmap = self._ttf.cmap
            self._units_per_em = self._ttf.units_per_em
            self._bbox = self._ttf.bbox
        self._reset()

    def load_ttf_file(self, path: str) -> None:
        with open(path, "rb") as f:
            self.load_ttf_bytes(f.read())

    def load_default(self) -> None:
        self.load_ttf_bytes(_default_font_bytes())

    def _reset(self) -> None:
        self._basic.clear()
        self._other.clear()

    # --- metrics -----------------------------------------------------
    def _scaleout(self) -> float:
        """1 / min(global bbox size) (reference font.go:208-212)."""
        xmin, ymin, xmax, ymax = self._bbox
        return 1.0 / min(xmax - xmin, ymax - ymin)

    def _glyph_name(self, char: str) -> int:
        """The glyph of `char` (its id: the port's glyph set is keyed by id)."""
        gid = self._cmap.get(ord(char))
        if gid is None:
            raise ValueError(f"char {char!r} has no glyph")
        return gid

    def advance_width(self, char: str) -> float:
        gs = self._glyphset[self._glyph_name(char)]
        return gs.width * self._scaleout()

    def kern(self, c0: str, c1: str) -> float:
        """Horizontal kerning adjustment for a glyph pair (the kern table's
        first subtable, version 0 format 0; 0 without one)."""
        pair = (self._glyph_name(c0), self._glyph_name(c1))
        return self._ttf.kern(*pair) * self._scaleout()

    # --- glyph construction ------------------------------------------
    def glyph(self, char: str):
        """2D SDF for a single character (reference font.go:159-165)."""
        code = ord(char)
        cache = self._basic if FIRST_BASIC <= code <= LAST_BASIC else self._other
        key = code if cache is self._basic else char
        g = cache.get(key)
        if g is None:
            g = self._make_glyph(char)
            cache[key] = g
        return g

    def text_line(self, s: str):
        """Single line of text with kerning and advance
        (reference font.go:89-141)."""
        shapes = []
        x_ofs = 0.0
        prev_char = None
        for ic, c in enumerate(s):
            if c in ("\n", "\r"):
                raise ValueError(f"char {c!r} not graphic")
            if c.isspace():
                adv = self.advance_width(" ")
                if c == "\t":
                    adv *= 4
                x_ofs += adv
                prev_char = None
                continue
            shape = self.glyph(c)
            if ic > 0 and prev_char is not None:
                x_ofs += self.kern(prev_char, c)
            prev_char = c
            shapes.append(self.bld.translate2d(shape, x_ofs, 0))
            x_ofs += self.advance_width(c)
        if len(shapes) == 1:
            return shapes[0]
        if not shapes:
            raise ValueError("no text provided")
        return self.bld.union2d(*shapes)

    def _make_glyph(self, char: str):
        with spans.span("textsdf.glyph"):
            contours = glyph_contours(
                self._glyphset, self._glyph_name(char), self._scaleout(), self.reltol
            )
            if not contours:
                raise ValueError(f"glyph {char!r} has no contours")
            # TrueType outer contours wind clockwise (negative signed area
            # in y-up coords); counter-clockwise contours are holes. Unlike
            # the reference (font.go:237-255, which assumes the first
            # contour is the filled outline), fills and holes are composed
            # irrespective of contour order: fonts like DejaVu list
            # counters first.
            fills, holes = [], []
            for pts in contours:
                (fills if signed_area(pts) < 0 else holes).append(self.bld.new_polygon(pts))
            if not fills:
                # degenerate glyph (all contours wind as holes): fall back
                # to treating them all as fills
                fills, holes = holes, []
            shape = fills[0] if len(fills) == 1 else self.bld.union2d(*fills)
            for h in holes:
                shape = self.bld.difference2d(shape, h)
        COUNTS["glyphs"] += 1
        COUNTS["contours"] += len(contours)
        COUNTS["vertices"] += sum(len(c) for c in contours)
        return shape


def signed_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


class _RecordingPen:
    """Keeps a glyph's pen calls as (operator, arguments) in `value`."""

    def __init__(self):
        self.value = []

    def moveTo(self, pt):
        self.value.append(("moveTo", (pt,)))

    def lineTo(self, pt):
        self.value.append(("lineTo", (pt,)))

    def qCurveTo(self, *pts):
        self.value.append(("qCurveTo", pts))

    def curveTo(self, *pts):
        self.value.append(("curveTo", pts))

    def closePath(self):
        self.value.append(("closePath", ()))


def glyph_contours(glyphset, name, scale: float, tol: float) -> List[np.ndarray]:
    """Extract flattened polygon contours of a glyph, scaled."""
    pen = _RecordingPen()
    glyphset[name].draw(pen)

    contours: List[np.ndarray] = []
    cur: List = []
    prev = (0.0, 0.0)

    def close():
        nonlocal cur
        if cur:
            # append the contour's final on-curve point (the implicit
            # closing segment runs from it back to the first point)
            cur.append(prev)
        if len(cur) >= 3:
            a = np.array(cur, _f32) * _f32(scale)
            # drop duplicate closing vertex
            if np.allclose(a[0], a[-1]):
                a = a[:-1]
            # drop consecutive duplicates
            keep = np.ones(len(a), bool)
            keep[1:] = np.any(np.abs(np.diff(a, axis=0)) > 1e-9, axis=1)
            a = a[keep]
            if len(a) >= 3:
                contours.append(a)
        cur = []

    for op, args in pen.value:
        if op == "moveTo":
            close()
            prev = args[0]
        elif op == "lineTo":
            cur.append(prev)
            prev = args[0]
        elif op == "qCurveTo":
            # TrueType: sequence of off-curve points with implied on-curve
            # midpoints; final arg is the on-curve end. A final None marks
            # an ALL-off-curve contour (a TrueType glyph draws it with NO
            # preceding moveTo): its implied on-curve start/end is the
            # midpoint of the LAST and FIRST off-curve points; `prev` is
            # stale from the previous contour and must not be used.
            pts = list(args)
            if pts[-1] is None:
                offs = pts[:-1]
                start = tuple((np.array(offs[-1], float) + np.array(offs[0], float)) / 2)
                end = start
            else:
                start = prev
                offs = pts[:-1]
                end = pts[-1]
            for i, c in enumerate(offs):
                if i < len(offs) - 1:
                    nxt = tuple((np.array(c) + np.array(offs[i + 1])) / 2)
                else:
                    nxt = end
                cur.append(start)
                _flatten_quad(cur, start, c, nxt, tol / max(scale, 1e-12), 4)
                start = nxt
            prev = end
        elif op == "curveTo":
            c1, c2, end = args
            cur.append(prev)
            _flatten_cubic(cur, prev, c1, c2, end, tol / max(scale, 1e-12), 4)
            prev = end
        elif op == "closePath":
            close()
    close()
    return contours


def _dist_point_line(p, a, b) -> float:
    ax, ay = a
    bx, by = b
    px, py = p
    dx, dy = bx - ax, by - ay
    l2 = dx * dx + dy * dy
    if l2 == 0:
        return float(np.hypot(px - ax, py - ay))
    return abs(dy * (px - ax) - dx * (py - ay)) / (l2**0.5)


def _flatten_quad(out, p0, c, p1, tol, depth):
    """Adaptive bisection of a quadratic bezier; appends interior points."""
    if depth <= 0 or _dist_point_line(c, p0, p1) <= tol:
        return
    m01 = ((p0[0] + c[0]) / 2, (p0[1] + c[1]) / 2)
    m12 = ((c[0] + p1[0]) / 2, (c[1] + p1[1]) / 2)
    mid = ((m01[0] + m12[0]) / 2, (m01[1] + m12[1]) / 2)
    _flatten_quad(out, p0, m01, mid, tol, depth - 1)
    out.append(mid)
    _flatten_quad(out, mid, m12, p1, tol, depth - 1)


def _flatten_cubic(out, p0, c1, c2, p1, tol, depth):
    if depth <= 0 or (
        _dist_point_line(c1, p0, p1) <= tol and _dist_point_line(c2, p0, p1) <= tol
    ):
        return
    m0 = ((p0[0] + c1[0]) / 2, (p0[1] + c1[1]) / 2)
    m1 = ((c1[0] + c2[0]) / 2, (c1[1] + c2[1]) / 2)
    m2 = ((c2[0] + p1[0]) / 2, (c2[1] + p1[1]) / 2)
    m01 = ((m0[0] + m1[0]) / 2, (m0[1] + m1[1]) / 2)
    m12 = ((m1[0] + m2[0]) / 2, (m1[1] + m2[1]) / 2)
    mid = ((m01[0] + m12[0]) / 2, (m01[1] + m12[1]) / 2)
    _flatten_cubic(out, p0, m0, m01, mid, tol, depth - 1)
    out.append(mid)
    _flatten_cubic(out, mid, m12, m2, p1, tol, depth - 1)
