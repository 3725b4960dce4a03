"""A reader of TrueType fonts (the `glyf` outlines of an sfnt file), in the
standard library alone: what textsdf needs of a font, so the port needs no
font package.

    ttf = TrueType(data)
    ttf.bbox, ttf.units_per_em          # head
    gid = ttf.cmap[ord("G")]            # the best Unicode cmap (format 4 or 12)
    ttf.advance(gid), ttf.kern(a, b)    # hmtx; kern, version 0, format 0
    ttf[gid].draw(pen)                  # moveTo / lineTo / qCurveTo / closePath

A glyph draws as fontTools draws a TrueType glyph (its glyf table's
`Glyph.draw`, the glyph set's left side bearing offset), so an outline
reaches the pen as the same calls with the same integer points: each
contour starts at its first on-curve point, a run of off-curve points is
one qCurveTo ending at the next on-curve point, the line back to the start
is left to closePath, and a contour with no on-curve point is one
qCurveTo(..., None). A composite glyph draws nothing (textsdf reads no
components). Fonts of CFF outlines ('OTTO'), collections and cubic glyf
points are refused.

The sfnt layout: Apple's TrueType Reference Manual and the OpenType
specification (tables head, maxp, hhea, hmtx, loca, glyf, cmap, kern).
"""
from __future__ import annotations

import struct

#: cmap subtables in the order the best is chosen (fontTools' and
#: HarfBuzz's): Windows full, Unicode full, Windows BMP, Unicode BMP, older
CMAP_PREFERENCES = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0))

_ON_CURVE, _X_SHORT, _Y_SHORT, _REPEAT, _X_SAME, _Y_SAME, _CUBIC = 1, 2, 4, 8, 16, 32, 128


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _i16(b, o):
    return struct.unpack_from(">h", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


class TrueType:
    """The tables of one TrueType font that textsdf reads."""

    def __init__(self, data: bytes):
        self.data = data = bytes(data)
        tag = data[:4]
        if tag == b"OTTO":
            raise ValueError("a font of CFF outlines: only TrueType glyf outlines are read")
        if tag not in (b"\x00\x01\x00\x00", b"true"):
            raise ValueError(f"not a TrueType font (sfnt version {tag!r})")
        self.tables = {}
        for i in range(_u16(data, 4)):
            rec = 12 + 16 * i
            self.tables[data[rec:rec + 4].decode("latin-1")] = (_u32(data, rec + 8),
                                                                _u32(data, rec + 12))
        for t in ("head", "maxp", "hhea", "hmtx", "loca", "glyf", "cmap"):
            if t not in self.tables:
                raise ValueError(f"TrueType font without a {t} table")
        head = self._table("head")
        self.units_per_em = _u16(head, 18)
        self.bbox = tuple(_i16(head, 36 + 2 * k) for k in range(4))  # xMin, yMin, xMax, yMax
        n = _u16(self._table("maxp"), 4)
        long_loca = _i16(head, 50) == 1
        loca = self._table("loca")
        self._loca = ([_u32(loca, 4 * i) for i in range(n + 1)] if long_loca
                      else [2 * _u16(loca, 2 * i) for i in range(n + 1)])
        hmtx, n_long = self._table("hmtx"), _u16(self._table("hhea"), 34)
        metrics = [(_u16(hmtx, 4 * i), _i16(hmtx, 4 * i + 2)) for i in range(n_long)]
        last = metrics[-1][0]
        metrics += [(last, _i16(hmtx, 4 * n_long + 2 * i)) for i in range(n - n_long)]
        self.metrics = metrics  # (advance width, left side bearing) by glyph id
        self.cmap = self._best_cmap()
        self._kern = self._kern_pairs()

    def _table(self, tag):
        off, length = self.tables[tag]
        return self.data[off:off + length]

    # --- character to glyph ----------------------------------------------
    def _best_cmap(self) -> dict:
        cmap = self._table("cmap")
        subtables = {}
        for i in range(_u16(cmap, 2)):
            rec = 4 + 8 * i
            subtables.setdefault((_u16(cmap, rec), _u16(cmap, rec + 2)), _u32(cmap, rec + 4))
        for key in CMAP_PREFERENCES:
            if key in subtables and _u16(cmap, subtables[key]) in (4, 12):
                return _cmap_subtable(cmap, subtables[key])
        return {}

    # --- metrics ---------------------------------------------------------
    def advance(self, gid: int) -> int:
        return self.metrics[gid][0]

    def _kern_pairs(self) -> dict:
        """{(left, right): value} of the kern table's first subtable, where it
        is version 0 and format 0; {} otherwise."""
        if "kern" not in self.tables:
            return {}
        kern = self._table("kern")
        if _u16(kern, 0) != 0 or _u16(kern, 2) < 1 or kern[8] != 0:
            return {}
        n = _u16(kern, 10)
        return {(_u16(kern, 18 + 6 * i), _u16(kern, 20 + 6 * i)): _i16(kern, 22 + 6 * i)
                for i in range(n)}

    def kern(self, left: int, right: int) -> int:
        return self._kern.get((left, right), 0)

    # --- outlines --------------------------------------------------------
    def __getitem__(self, gid: int) -> "Glyph":
        if not 0 <= gid < len(self.metrics):
            raise KeyError(gid)
        return Glyph(self, gid)

    def contours(self, gid: int):
        """([contour: [(x, y, on_curve)]], xMin) of a simple glyph; ([], None)
        for an empty or composite glyph."""
        start, end = self._loca[gid], self._loca[gid + 1]
        if end <= start:
            return [], None
        g = self._table("glyf")[start:end]
        n = _i16(g, 0)
        if n <= 0:
            return [], None
        ends = [_u16(g, 10 + 2 * i) for i in range(n)]
        at = 10 + 2 * n
        at += 2 + _u16(g, at)  # the instructions
        count = ends[-1] + 1
        flags = []
        while len(flags) < count:
            f = g[at]
            at += 1
            reps = 1
            if f & _REPEAT:
                reps += g[at]
                at += 1
            flags += [f] * reps
        if any(f & _CUBIC for f in flags):
            raise ValueError(f"glyph {gid} has cubic glyf points")
        coords = []
        for short, same in ((_X_SHORT, _X_SAME), (_Y_SHORT, _Y_SAME)):
            v, out = 0, []
            for f in flags[:count]:
                if f & short:
                    v += g[at] if f & same else -g[at]
                    at += 1
                elif not f & same:
                    v += _i16(g, at)
                    at += 2
                out.append(v)
            coords.append(out)
        pts = [(x, y, bool(f & _ON_CURVE)) for x, y, f in zip(*coords, flags)]
        starts = [0] + [e + 1 for e in ends[:-1]]
        return [pts[s:e + 1] for s, e in zip(starts, ends)], _i16(g, 2)


class Glyph:
    """One glyph of a TrueType font, drawn onto a pen."""

    def __init__(self, font: TrueType, gid: int):
        self.font, self.gid = font, gid
        self.width = font.advance(gid)

    def draw(self, pen) -> None:
        contours, x_min = self.font.contours(self.gid)
        dx = self.font.metrics[self.gid][1] - x_min if contours else 0
        for contour in contours:
            pts = [(x + dx, y) for x, y, _ in contour]
            on = [o for _, _, o in contour]
            if not any(on):
                pen.qCurveTo(*pts, None)
                pen.closePath()
                continue
            # start at the first on-curve point; each run of off-curve
            # points up to the next on-curve point is one segment
            k = on.index(True) + 1
            pts, on = pts[k:] + pts[:k], on[k:] + on[:k]
            pen.moveTo(pts[-1])
            while pts:
                nxt = on.index(True) + 1
                if nxt == 1:
                    if len(pts) > 1:  # the line back to the start is closePath's
                        pen.lineTo(pts[0])
                else:
                    pen.qCurveTo(*pts[:nxt])
                pts, on = pts[nxt:], on[nxt:]
            pen.closePath()


def _cmap_subtable(cmap: bytes, off: int) -> dict:
    """{code point: glyph id} of one cmap subtable of format 4 (the BMP by
    segments) or 12 (groups of 32-bit codes)."""
    out = {}
    if _u16(cmap, off) == 4:
        segs = _u16(cmap, off + 6) // 2
        ends, starts = off + 14, off + 16 + 2 * segs
        deltas, ranges = starts + 2 * segs, starts + 4 * segs
        for i in range(segs):
            first, last = _u16(cmap, starts + 2 * i), _u16(cmap, ends + 2 * i)
            delta, ro = _i16(cmap, deltas + 2 * i), _u16(cmap, ranges + 2 * i)
            for c in range(first, last + 1):
                if c == 0xFFFF:
                    continue
                if ro == 0:
                    gid = (c + delta) & 0xFFFF
                else:
                    gid = _u16(cmap, ranges + 2 * i + ro + 2 * (c - first))
                    gid = (gid + delta) & 0xFFFF if gid else 0
                out[c] = gid
    else:
        for i in range(_u32(cmap, off + 12)):
            rec = off + 16 + 12 * i
            first, last, gid = _u32(cmap, rec), _u32(cmap, rec + 4), _u32(cmap, rec + 8)
            out.update({c: gid + c - first for c in range(first, last + 1)})
    return out
