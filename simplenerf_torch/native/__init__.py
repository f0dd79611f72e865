"""Native (C++) host ops, built at first use and bound with ctypes.

Port of simplenerf_tpu/native/: the visibility-mask forward splat's
scatter-accumulate (`bilinear_splat`, warp.cpp), which `qa.masks` calls.
It runs on the host, as in the JAX package. The library is compiled with
`g++` into `build/native/` at the repository root (listed in .gitignore),
under a name that carries a hash of the source, the compiler and its
flags, so an edited source is rebuilt and an unchanged one reused. There
is no fallback: a compiler that is missing or fails raises, with its
stderr. The numpy body in `qa.masks` is the plain version that tests hold
this op against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "warp.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    data = SOURCE.read_bytes() + " ".join((CXX, *CXX_FLAGS)).encode()
    return BUILD_DIR / f"libwarp_{hashlib.sha256(data).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile warp.cpp unless a build of this exact source and flags exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"the native splat needs a C++ compiler: {CXX!r} not found") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{CXX} failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The built library with its argtypes set (built on first call)."""
    path = library_path()
    lib = _loaded.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.bilinear_splat.argtypes = [
            dp, dp, dp,        # values, trans_pos, depth
            ctypes.c_void_p,   # mask (uint8*) or NULL
            ctypes.c_long, ctypes.c_long, ctypes.c_long,  # h, w, c
            dp, dp,            # acc, acc_w
        ]
        lib.bilinear_splat.restype = None
        _loaded[path] = lib
    return lib


def bilinear_splat_accumulate(
    values: np.ndarray,
    trans_pos: np.ndarray,
    depth: np.ndarray,
    mask: Optional[np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Scatter-accumulate onto the padded (h+2, w+2) canvas: (acc (h+2,
    w+2, c), acc_w (h+2, w+2)), float64. The semantics of the numpy plain
    version in qa.masks.bilinear_splat (reference Warper.py:99-181)."""
    h, w, c = values.shape
    if trans_pos.shape != (h, w, 2) or depth.shape != (h, w):
        raise ValueError(f"trans_pos {trans_pos.shape} / depth {depth.shape} do not match "
                         f"values {values.shape}")
    if mask is not None and mask.shape != (h, w):
        raise ValueError(f"mask {mask.shape} does not match values {values.shape}")
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.float64)
    trans_pos = np.ascontiguousarray(trans_pos, dtype=np.float64)
    depth = np.ascontiguousarray(depth, dtype=np.float64)
    mask_arr = None if mask is None else np.ascontiguousarray(mask, dtype=np.uint8)
    acc = np.zeros((h + 2, w + 2, c), dtype=np.float64)
    acc_w = np.zeros((h + 2, w + 2), dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.bilinear_splat(
        values.ctypes.data_as(dp), trans_pos.ctypes.data_as(dp), depth.ctypes.data_as(dp),
        None if mask_arr is None else mask_arr.ctypes.data_as(ctypes.c_void_p),
        h, w, c, acc.ctypes.data_as(dp), acc_w.ctypes.data_as(dp),
    )
    return acc, acc_w
