"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is one `.cu` file under `csrc/` with a plain C interface,
compiled by `nvcc` for sm_90a into `build/kernels/` at the repository root
(listed in .gitignore). The output name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures of the entry points, per library.
_SIGNATURES = {
    "fused_mlp_fwd": {
        "snerf_fused_mlp_fwd": (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_void_p]
        ),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_library(name: str) -> Path:
    """Compile csrc/<name>.cu unless a build of this exact source exists.

    The compiler's output (ptxas register and shared-memory report) is kept
    beside the library as `<lib>.log`.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The built library with argtypes/restype set (built on first call)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
