"""Screw, nut and knurl machinery of the ported slice."""
from .core import Basic, Parameters, ScrewNode, Threader, metric_f2f, screw
from .fasteners import KnurlParams, NutParams, NutStyle, knurl, knurled_head, nut
from .standards import ISO, NPT, PlasticButtress

__all__ = [
    "Basic",
    "ISO",
    "KnurlParams",
    "NPT",
    "NutParams",
    "NutStyle",
    "Parameters",
    "PlasticButtress",
    "ScrewNode",
    "Threader",
    "knurl",
    "knurled_head",
    "metric_f2f",
    "nut",
    "screw",
]
