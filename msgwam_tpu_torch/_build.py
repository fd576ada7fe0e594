"""Build and load the port's CUDA kernels.

At first use :func:`library` compiles every ``csrc/*.cu`` into an object,
one ``nvcc`` per source, all started together, and links the objects into
one shared library with a plain C interface, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<hash>/<name>.o csrc/<name>.cu
    nvcc -shared -o _build/libmsgwam_<hash>.so _build/<hash>/*.o

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch twins compute them: a contracted ``r_up * idz + 1`` could
otherwise pick a different cell on a face.

The library name carries a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded.  Only the sources in this
package are used; the compiler's report (registers, spills) is kept beside
the library as ``<name>.log``.

:func:`forward_only` is the guard of the two entry points that have no
backward, as in the JAX package: K1 and K6.  The others differentiate
the plain path in their backward (``ops/adjoint.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    "msgwam_project_plan": [
        _I, _I,                       # n n_cells
        _P,                           # out[3]
    ],
    "msgwam_project": [
        _P, _P, _P, _P, _P, _P, _P,   # v0 v1 r_low r_up phase_vol valid grid
        _I, _I,                       # n n_cells
        _P, _P, _P, _P, _I,           # out partials ranges sync parity
        _I, _I,                       # n_blocks n_red
        _P,                           # stream
    ],
    "msgwam_rhs_plan": [
        _I, _I,                       # n n_flux
        _P,                           # out[3]
    ],
    "msgwam_rhs_fused": [
        _P, _P, _P, _P, _P, _I,       # centers faces u v rhobar n_tab
        _F, _F, _F, _F,               # dt bvf kappa f0
        _P, _P, _P, _P, _P, _P, _P, _P,   # dens r dr k l m dm phi
        _P, _P, _P, _P,               # dkk dll area active
        _I,                           # n
        _P, _P, _P, _P,               # dens_st drr_st dmm_st flux
        _P, _P, _P, _I,               # partials ranges sync parity
        _I, _I, _I, _I,               # n_blocks n_red saturate_online faithful
        _P,                           # stream
    ],
    "msgwam_rhs_windowed": [
        _P, _P, _P, _P, _P, _P,       # centers faces u v rhobar pg
        _I, _I, _I, _I,               # n_tab c_pad w1 w2
        _F, _F, _F, _F, _F,           # dt bvf kappa f0 ff0
        _P, _P, _P, _P, _P, _P, _P, _P,   # dens r dr k l m dm phi
        _P, _P, _P, _P,               # dkk dll area active
        _I,                           # n
        _P, _P, _P, _P, _P, _P,       # out_dens out_r out_m q_dens q_r q_m
        _P, _P, _P, _P,               # u_out v_out qu qv
        _P, _P, _P, _P, _I, _P,       # flux partials ranges sync parity tiers
        _P,                           # tier_counts
        _I, _I, _I, _I,               # n_blocks n_red saturate_online faithful
        _I, _I,                       # staged tail
        _F, _F, _I,                   # cc bc first
        _P,                           # stream
    ],
    "msgwam_step_resident_plan": [
        _I, _I, _I, _I, _I, _I, _I,   # n_per n_members c_pad n_flux online prognostic stream
        _P,                           # out[7]
    ],
    "msgwam_step_resident": [
        _F, _F, _F, _F, _F, _F, _F, _F, _F,   # g0c dz g0f dzf dt bvf kappa f0 rdiv
        _I, _I, _I, _I,               # n_tab c_pad w1 w2
        _P, _P, _P, _P, _P, _P, _P, _P, _P,   # dr k l dm phi dkk dll area act
        _I, _I,                       # n_per n_members
        _P, _P, _P, _P, _P, _P,       # dens r m qd qr qm
        _P, _P, _P,                   # r_prev m_prev dens_prop
        _P, _P, _P, _P,               # uv rhobar pg inv_rho
        _P, _P, _P, _P, _P,           # flux partials sync inv win
        _I, _I,                       # blocks_per_member n_steps
        _I, _I, _I, _I,               # online prognostic faithful stream
        _I, _F, _F, _F,               # cull m_max face_lo face_hi
        _P, _P, _P, _P,               # src_dens src_r src_m src_act
        _P, _I,                       # wind wind_rows
        _P,                           # tier_counts
        _P,                           # cuda_stream
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
    """Compile the sources unless a library of their hash exists: one
    ``nvcc -c`` per source, run in parallel, then one link."""
    lib = library_path()
    if lib.is_file():
        return lib
    obj_dir = lib.with_suffix("")
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = [p for p in _sources() if p.suffix == ".cu"]
    objs = [obj_dir / f"{p.stem}.{os.getpid()}.o" for p in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p, o in zip(sources, objs)]
    logs = [f"== {p.name}\n{proc.communicate()[0]}"
            for p, proc in zip(sources, procs)]
    failed = [p.name for p, proc in zip(sources, procs) if proc.returncode]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode:
            failed.append("link")
    lib.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "".join(logs))
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


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def forward_only(name: str, route: str, *trees) -> None:
    """Raise when autograd would record through an entry point that has no
    backward (K1, K6): its kernel returns tensors without a ``grad_fn``,
    so a gradient would otherwise vanish without a word.  ``route`` names
    the differentiable way to the same result.  Checked on every device
    alike."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(trees)):
        raise NotImplementedError(
            f"{name} is forward only, as in the JAX package; run it under "
            f"torch.no_grad(), or use {route} for gradients")
