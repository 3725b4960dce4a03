"""Build-at-first-use of the port's native libraries.

Every library (the per-tree CUDA kernels, the host decoder) is compiled
from sources in this checkout into `build/gsdf_tpu_torch/<name>-<key>/`
under the checkout root, keyed by a hash of its sources and flags, and
loaded with ctypes. A build is written under a temporary name and renamed
into place, so concurrent processes never load a half-written library.
A failed build raises: nothing on the port's path falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Callable, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "gsdf_tpu_torch")


def source_key(*parts: str | bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode() if isinstance(p, str) else p)
        h.update(b"\0")
    return h.hexdigest()[:16]


def write_atomic(path: str, text: str) -> None:
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == text:
                return
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build_shared(
    name: str,
    key: str,
    command: Callable[[str, str], Sequence[str]],
    timeout: float = 600.0,
) -> str:
    """Path of the shared library `name` for `key`, compiled on first use.

    command(out_path, build_dir) gives the compiler argv; its output is
    kept in build.log beside the library."""
    d = os.path.join(BUILD_DIR, f"{name}-{key}")
    so = os.path.join(d, f"lib{name}.so")
    if os.path.exists(so):
        return so
    os.makedirs(d, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    argv = list(command(tmp, d))
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
    write_atomic(
        os.path.join(d, "build.log"),
        " ".join(argv) + "\n" + proc.stdout + proc.stderr,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed (exit {proc.returncode}):\n"
            + (proc.stderr or proc.stdout)[-4000:]
        )
    os.replace(tmp, so)
    return so


def load(path: str, signatures: dict) -> ctypes.CDLL:
    """CDLL with argtypes/restype declared for every named function."""
    lib = ctypes.CDLL(path)
    for fn, (restype, argtypes) in signatures.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib
