"""Build and load the port's CUDA kernels.

At first use :func:`library` compiles every ``csrc/*.cu`` into one shared
library with a plain C interface and loads it with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -Xptxas -v -o _build/libmsgwam_<hash>.so csrc/*.cu

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch twins compute them: a contracted ``r_up * idz + 1`` could
otherwise pick a different cell on a face.

The library name carries a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded.  Only the sources in this
package are used; the compiler's report (registers, spills) is kept beside
the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    "msgwam_project": [
        _P, _P, _P, _P, _P, _P, _P,   # v0 v1 r_low r_up phase_vol valid grid
        _I, _I,                       # n n_cells
        _P, _P, _I,                   # out partials n_blocks
        _P,                           # stream
    ],
    "msgwam_rhs_fused": [
        _P, _F, _F, _F, _F,           # params(g0c, dz, g0f) dt bvf kappa f0
        _P, _P, _P, _I,               # du_dz dv_dz rhobar n_tab
        _P, _P, _P, _P, _P, _P, _P, _P,   # dens r dr k l m dm phi
        _P, _P, _P, _P,               # dkk dll area active
        _I,                           # n
        _P, _P, _P, _P, _P, _I,       # dens_st drr_st dmm_st flux partials n_blocks
        _I, _I,                       # saturate_online faithful
        _P,                           # stream
    ],
}


def _sources():
    return sorted(list(SRC_DIR.glob("*.cu")) + list(SRC_DIR.glob("*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmsgwam_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of their hash exists."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
