"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is one `.cu` file under `csrc/` with a plain C interface,
compiled by `nvcc` for sm_90a into `build/kernels/` at the repository root
(listed in .gitignore). The output name carries a hash of the source, the
headers it may include (`csrc/*.cuh`) and the flags, so an edited source is
rebuilt and an unchanged one is reused. `build_all` starts one nvcc per
source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from simplenerf_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points, per library.
_SIGNATURES = {
    "fused_mlp_fwd": {
        "snerf_fused_mlp_fwd": [_I, _P, _I] + [_P] * 6 + [_I, _P],
        "snerf_fused_mlp_fwd_pre": [_I, _P, _I] + [_P] * 7 + [_I, _P],
        "snerf_fused_mlp_ens_fwd": [_I, _P, _I] + [_P] * 5 + [_I, _P],
        "snerf_tf32_split": [_P, _P, ctypes.c_longlong, _P],
    },
    "fused_mlp_bwd": {
        "snerf_fused_mlp_bwd": [_I, _P, _I] + [_P] * 7 + [_I] * 5 + [_P] * 9 + [_I] + [_P] * 2
                               + [_I, _P],
        "snerf_fused_mlp_bwd_sec": [_I, _P, _I] + [_P] * 7 + [_I] * 5 + [_P] * 9 + [_I] + [_P] * 2
                                   + [_I, _P, _P],
        "snerf_fused_mlp_ens_bwd": [_I, _P, _I] + [_P] * 6 + [_I] * 5 + [_P] * 9 + [_I]
                                   + [_P] * 2 + [_I, _P],
        "snerf_wgrad": [_I, _P, _P, _I, _P] + [_I] * 5 + [_P, _P, _I, _P, _P],
        "snerf_colsum": [_P, _P] + [_I] * 4 + [_P, _P],
    },
    "fused_mlp_sec": {
        "snerf_sec_fwd": [_P] * 5 + [_I] * 5 + [_P],
        "snerf_sec_bwd": [_P] * 7 + [_I] * 5 + [_P],
    },
    "field_pe": {
        "snerf_field_pe": [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P],
    },
}
LIBRARIES = tuple(_SIGNATURES)

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
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    data = b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(data).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=LIBRARIES) -> dict[str, Path]:
    """Compile every csrc/<name>.cu that has no build of its exact source,
    one nvcc process per source, all started together.

    The compiler's output (ptxas register and shared-memory report) is kept
    beside each library as `<lib>.log`.
    """
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}:\n{log}")
            continue
        todo[name].with_suffix(".log").write_text(log)
        os.replace(tmp, todo[name])  # atomic: concurrent builders never see a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build_library(name: str) -> Path:
    """Compile csrc/<name>.cu unless a build of this exact source exists."""
    return build_all((name,))[name]


def load_library(name: str) -> ctypes.CDLL:
    """The built library with argtypes/restype set (built on first call)."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("kernels.load"):
            lib = ctypes.CDLL(str(build_library(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
