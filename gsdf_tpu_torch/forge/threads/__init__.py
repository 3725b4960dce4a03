"""Screw, bolt, nut and knurl machinery (gsdf_tpu/forge/threads)."""
from .core import Basic, Parameters, ScrewNode, Threader, metric_f2f, screw
from .fasteners import (
    BoltParams,
    KnurlParams,
    NutParams,
    NutStyle,
    bolt,
    chamfered_cylinder,
    hex_head,
    knurl,
    knurled_head,
    nut,
)
from .standards import NPT, UTS, Acme, ANSIButtress, ISO, PlasticButtress

__all__ = [
    "Acme",
    "ANSIButtress",
    "Basic",
    "BoltParams",
    "ISO",
    "KnurlParams",
    "NPT",
    "NutParams",
    "NutStyle",
    "Parameters",
    "PlasticButtress",
    "ScrewNode",
    "Threader",
    "UTS",
    "bolt",
    "chamfered_cylinder",
    "hex_head",
    "knurl",
    "knurled_head",
    "metric_f2f",
    "nut",
    "screw",
]
