"""State containers of the PyTorch port.

The counterpart of :mod:`msgwam_tpu.state`: the same ``NamedTuple``s with
the same field order, holding ``torch.Tensor`` leaves instead of
``jax.Array`` ones.

* :class:`RayState`   — the nine per-ray fields, each ``(capacity,)``.
* :class:`MeanState`  — the two mean-flow winds, each ``(n_cell,)``.
* :class:`State`      — (rays, mean), the tree the RK3 stages update.
* :class:`RayStatics` — per-ray constants plus the ``active`` mask.
* :class:`Background` — grid, hydrostatic density, pressure gradient.

A leaf of a tendency tree may be the Python float ``0.0`` instead of a
tensor: a *structural* zero for a field that never changes (see
``models/rhs.py``).  :func:`tree_axpy` and the integrators leave such
fields untouched instead of materialising and adding zeros.

:func:`from_numpy` and :func:`to_numpy` carry the state across the package
boundary: ``msgwam_tpu``'s trees (or any tree of array-likes with these
type names) become the port's tensors on a chosen device and dtype, and
back.  That is how the tests feed both packages the same inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import GridConfig, ModelConfig
from .constants import ROT_EARTH


class RayState(NamedTuple):
    """Per-ray integrated fields, each shape ``(capacity,)``."""

    dens: torch.Tensor  # phase-space wave-action density
    lam: torch.Tensor   # longitude [rad]
    phi: torch.Tensor   # latitude [rad]
    r: torch.Tensor     # ray-volume center height [m]
    dr: torch.Tensor    # ray-volume vertical extent [m]
    k: torch.Tensor     # zonal wavenumber
    l: torch.Tensor     # meridional wavenumber
    m: torch.Tensor     # vertical wavenumber (center)
    dm: torch.Tensor    # ray-volume extent in m


class MeanState(NamedTuple):
    """Mean-flow winds on cell centers, shape ``(n_cell,)``."""

    u: torch.Tensor
    v: torch.Tensor


class State(NamedTuple):
    rays: RayState
    mean: MeanState


class RayStatics(NamedTuple):
    """Per-ray constants + activity mask (not integrated)."""

    dkk: torch.Tensor         # ray-volume extent in k
    dll: torch.Tensor         # ray-volume extent in l
    rr_mm_area: torch.Tensor  # conserved r-m phase-space area
    active: torch.Tensor      # bool mask


class Background(NamedTuple):
    """Immutable background for a run."""

    faces: torch.Tensor              # (n_face,) grid faces
    centers: torch.Tensor            # (n_cell,) cell centers
    rhobar: torch.Tensor             # (n_cell,) hydrostatic density
    pressure_gradient: torch.Tensor  # (2, n_cell)


_TYPES = {cls.__name__: cls for cls in
          (RayState, MeanState, State, RayStatics, Background)}

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name) -> torch.dtype:
    """``cfg.dtype`` string (or a torch dtype) to a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; use one of "
                         f"{sorted(_DTYPES)}") from None


def coriolis(phi, dtype=None):
    """f = 2 Ω sin φ, for a tensor or a Python float."""
    if isinstance(phi, torch.Tensor):
        f = 2.0 * ROT_EARTH * torch.sin(phi)
        return f.to(dtype) if dtype is not None else f
    return 2.0 * ROT_EARTH * math.sin(phi)


def default_device(device=None) -> torch.device:
    """The device a builder puts its tensors on: ``device`` when given,
    else the card.  Without one the call fails here, naming the missing
    card, instead of going on quietly on the CPU: a caller who wants the
    CPU (the tests do) passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: msgwam_tpu_torch builds its tensors on the card "
            "unless the caller asks for another device; pass device='cpu' to "
            "run on the CPU")
    return torch.device("cuda")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_background(
    grid_cfg: GridConfig,
    cfg: ModelConfig,
    u_init,
    v_init,
    dtype=torch.float64,
    device=None,
) -> Background:
    """Build the run background: exponential (or Boussinesq-constant)
    density on cell centers, and the fixed pressure gradient that balances
    the *initial* winds at latitude ``phi0``.

    The arithmetic runs on the host in NumPy, exactly as
    ``msgwam_tpu.state.make_background`` does: NumPy's ``exp`` and
    ``linspace`` are the reference's, and device transcendentals that
    differ by an ulp seed trajectory divergence through the saturation
    clamps.  Only the finished arrays go to ``device``: the card unless
    another device is given (:func:`default_device`).
    """
    device = default_device(device)
    faces_np = grid_cfg.faces()
    centers_np = grid_cfg.centers()
    if cfg.boussinesq:
        rhobar_np = cfg.rhobar0 * np.ones_like(centers_np)
    else:
        rhobar_np = cfg.rhobar0 * np.exp(-centers_np / cfg.hh)
    ff = 2.0 * ROT_EARTH * np.sin(cfg.phi0)
    u_np = np.asarray(_host(u_init), dtype=np.float64)
    v_np = np.asarray(_host(v_init), dtype=np.float64)
    pressure_gradient = np.stack([rhobar_np * ff * v_np, -rhobar_np * ff * u_np])
    dtype = torch_dtype(dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return Background(t(faces_np), t(centers_np), t(rhobar_np),
                      t(pressure_gradient))


# ---------------------------------------------------------------------------
# tree arithmetic (the RK3 stage updates are elementwise over State)
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over matching ``NamedTuple``/tuple trees.
    Leaves are tensors or Python floats (structural zeros)."""
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, *children) for children in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    return fn(tree, *rest)


def tree_axpy(s, x, y):
    """y + s * x leaf-wise; a structural-zero leaf of ``x`` leaves ``y``
    as it is."""
    def axpy(xi, yi):
        if isinstance(xi, float) and xi == 0.0:
            return yi
        return yi + s * xi
    return tree_map(axpy, x, y)


def pad_rays(rays: RayState, statics: RayStatics, capacity: int):
    """Pad ray buffers up to ``capacity`` with inactive, numerically safe
    slots (nonzero wavevector so dispersion math stays finite)."""
    n = rays.dens.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < number of rays {n}")
    pad = capacity - n
    if pad == 0:
        return rays, statics

    def pad_field(x, fill):
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                        device=x.device)])

    rays = RayState(
        dens=pad_field(rays.dens, 0.0),
        lam=pad_field(rays.lam, 0.0),
        phi=pad_field(rays.phi, 0.0),
        r=pad_field(rays.r, 0.0),
        dr=pad_field(rays.dr, 1.0),
        k=pad_field(rays.k, 1e-5),
        l=pad_field(rays.l, 0.0),
        m=pad_field(rays.m, -1e-3),
        dm=pad_field(rays.dm, 1e-6),
    )
    statics = RayStatics(
        dkk=pad_field(statics.dkk, 1.0),
        dll=pad_field(statics.dll, 1.0),
        rr_mm_area=pad_field(statics.rr_mm_area, 0.0),
        active=pad_field(statics.active, False),
    )
    return rays, statics


# ---------------------------------------------------------------------------
# carry-over between msgwam_tpu (NumPy leaves) and the port (tensors)
# ---------------------------------------------------------------------------

def from_numpy(tree, device=None, dtype=None):
    """Turn a tree of array-likes into the port's tensors.

    ``tree`` is a ``RayState``/``MeanState``/``State``/``RayStatics``/
    ``Background`` of either package (matched by type name), a plain tuple
    of such trees, or a single array, on ``device``: the card unless
    another device is given (:func:`default_device`).  Float leaves are cast
    to ``dtype`` (default: keep their own); bool leaves stay bool.  Python
    floats (structural zeros) pass through unchanged.
    """
    device = default_device(device)
    dtype = None if dtype is None else torch_dtype(dtype)
    if isinstance(tree, tuple):
        children = [from_numpy(c, device, dtype) for c in tree]
        cls = _TYPES.get(type(tree).__name__)
        if cls is not None:
            return cls(*children)
        return tuple(children)
    if isinstance(tree, float):
        return tree
    arr = np.array(_host(tree))  # a writable host copy
    t = torch.from_numpy(arr).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def to_numpy(tree):
    """The inverse of :func:`from_numpy`: the same tree with NumPy leaves
    (structural-zero floats pass through)."""
    return tree_map(lambda x: x if isinstance(x, float) else _host(x), tree)
