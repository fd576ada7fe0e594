"""Streaming history IO: the counterpart of
:mod:`msgwam_tpu.utils.history_io`, writing the same "MSGW" v1 files byte
for byte.

A long run at 1e6 rays cannot keep its history in host memory (~50 MB a
frame), so decimated frames stream to disk while the card computes the
next chunk.  The hot path is the repository's native writer
(``native/history_writer.cc``: a bounded queue drained by a background
thread, no framework in it), compiled at first use with ``g++`` into the
port's build directory (``msgwam_tpu_torch/_build/``, beside the CUDA
library) and loaded with ``ctypes``; a Python thread with the same
protocol takes its place where it does not build.

File format "MSGW" v1: 16-byte header (magic ``MSGW``, u32 version, u64
record_bytes), then fixed-size records back to back, and a ``.json``
sidecar with the record shape and dtype.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import queue as _queue
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .._build import BUILD_DIR

_MAGIC = b"MSGW"
_HEADER = struct.Struct("<4sIQ")

SOURCE = Path(__file__).resolve().parents[2] / "native" / "history_writer.cc"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread", "-shared"]
_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """The native writer's library, named by a hash of its source and
    flags, so an edited source is rebuilt."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmsgwam_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the native writer unless a library of its hash exists."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, lib)
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    """The native writer library, built at first use; ``None`` where it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError):
            _lib = False
            return None
        lib.msgwam_writer_open.restype = ctypes.c_void_p
        lib.msgwam_writer_open.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ]
        lib.msgwam_writer_push.restype = ctypes.c_int
        lib.msgwam_writer_push.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.msgwam_writer_pending.restype = ctypes.c_uint64
        lib.msgwam_writer_pending.argtypes = [ctypes.c_void_p]
        lib.msgwam_writer_close.restype = ctypes.c_int64
        lib.msgwam_writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class HistoryWriter:
    """Append fixed-size float32/float64 records asynchronously.

    ``native=None`` takes the native writer where it builds and the Python
    thread otherwise, ``True`` raises where the native writer is
    unavailable, ``False`` takes the Python thread.

    >>> w = HistoryWriter(path, record_shape=(2, 100), dtype=np.float32)
    >>> w.push(snapshot)        # returns at once (bounded queue)
    >>> w.close()
    """

    def __init__(self, path, record_shape, dtype=np.float32,
                 max_queue: int = 16, native: Optional[bool] = None):
        self.path = str(path)
        self.record_shape = tuple(int(s) for s in record_shape)
        self.dtype = np.dtype(dtype)
        self.record_bytes = int(np.prod(self.record_shape)) * self.dtype.itemsize
        self._closed = False
        self._count = 0

        lib = _load_native() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native history writer unavailable")
        self._lib = lib
        if lib is not None:
            self._handle = lib.msgwam_writer_open(
                self.path.encode(), self.record_bytes, max_queue)
            if not self._handle:
                raise OSError(f"cannot open {self.path}")
        else:
            self._fh = open(self.path, "wb")
            self._fh.write(_HEADER.pack(_MAGIC, 1, self.record_bytes))
            self._q: _queue.Queue = _queue.Queue(maxsize=max_queue)
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

        # sidecar metadata so readers can rebuild shapes and dtypes
        with open(self.path + ".json", "w") as f:
            json.dump({"record_shape": self.record_shape,
                       "dtype": self.dtype.name}, f)

    def _drain(self):
        while True:
            rec = self._q.get()
            if rec is None:
                return
            self._fh.write(rec)

    def push(self, record) -> None:
        """Queue one record (an array or a tensor, copied to the host)."""
        if self._closed:
            raise ValueError("writer closed")
        arr = np.ascontiguousarray(_host(record), dtype=self.dtype)
        if arr.nbytes != self.record_bytes:
            raise ValueError(
                f"record has {arr.nbytes} bytes, expected {self.record_bytes}")
        if self._lib is not None:
            rc = self._lib.msgwam_writer_push(
                self._handle, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
            if rc != 0:
                raise OSError("native writer failed")
        else:
            self._q.put(arr.tobytes())
        self._count += 1

    @property
    def pending(self) -> int:
        if self._closed:
            return 0
        if self._lib is not None:
            return int(self._lib.msgwam_writer_pending(self._handle))
        return self._q.qsize()

    def close(self) -> int:
        """Drain the queue, close the file and return the records written."""
        if self._closed:
            return self._count
        self._closed = True
        if self._lib is not None:
            written = int(self._lib.msgwam_writer_close(self._handle))
            if written < 0:
                raise OSError("native writer IO error")
        else:
            self._q.put(None)
            self._thread.join()
            self._fh.close()
            written = self._count
        return written

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_history(path):
    """Read back a streamed history file -> (n_records, *record_shape)."""
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    shape = tuple(meta["record_shape"])
    dtype = np.dtype(meta["dtype"])
    with open(path, "rb") as f:
        magic, version, record_bytes = _HEADER.unpack(f.read(_HEADER.size))
        if magic != _MAGIC or version != 1:
            raise ValueError("not a MSGW v1 history file")
        payload = f.read()
    n = len(payload) // record_bytes
    flat = np.frombuffer(payload[: n * record_bytes], dtype=dtype)
    return flat.reshape((n,) + shape)


#: per-ray fields in record order, then mask/aux, then grid fields
_RAY_FIELDS = ("dens", "lam", "phi", "r", "dr", "k", "l", "m", "dm",
               "dens_prop", "active")
_MEAN_FIELDS = ("u", "v")


class StateHistoryWriter:
    """Stream complete decimated ray-state frames (the nine integrated ray
    fields, the propagated density, the activity mask and the mean winds)
    through :class:`HistoryWriter`: one fixed-size flat record per frame.

    Layout per record (all cast to ``dtype``): 11 × capacity (ray fields in
    :data:`_RAY_FIELDS` order, ``active`` stored as 0/1) followed by
    2 × n_cell (u, v).  A ``.json`` sidecar carries the layout for
    :func:`read_state_history`.
    """

    def __init__(self, path, capacity: int, n_cell: int, dtype=np.float32,
                 max_queue: int = 4, native: Optional[bool] = None):
        self.capacity = int(capacity)
        self.n_cell = int(n_cell)
        self.dtype = np.dtype(dtype)
        n_flat = len(_RAY_FIELDS) * self.capacity + len(_MEAN_FIELDS) * self.n_cell
        self._w = HistoryWriter(path, (n_flat,), dtype=dtype,
                                max_queue=max_queue, native=native)
        with open(str(path) + ".json", "w") as f:
            json.dump({
                "record_shape": [n_flat],
                "dtype": self.dtype.name,
                "state_layout": {
                    "capacity": self.capacity,
                    "n_cell": self.n_cell,
                    "ray_fields": list(_RAY_FIELDS),
                    "mean_fields": list(_MEAN_FIELDS),
                },
            }, f)

    def push_frame(self, rays, active, dens_prop, mean) -> None:
        """Pack one frame (RayState-like, mask, dens_prop, MeanState-like)
        of tensors or arrays.  The record is assembled where the first
        tensor lies and copied to the host once."""
        rays_parts = [getattr(rays, f) for f in _RAY_FIELDS[:9]]
        rays_parts += [dens_prop, active]
        mean_parts = [getattr(mean, f) for f in _MEAN_FIELDS]
        device = next((p.device for p in rays_parts + mean_parts
                       if isinstance(p, torch.Tensor)), torch.device("cpu"))
        dtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        flat = []
        for parts, size in ((rays_parts, self.capacity),
                            (mean_parts, self.n_cell)):
            for p in parts:
                p = torch.as_tensor(p, device=device).reshape(-1)
                if p.numel() != size:
                    raise ValueError(f"frame field of {p.numel()} entries, "
                                     f"expected {size}")
                flat.append(p.to(dtype))
        self._w.push(torch.cat(flat).cpu().numpy())

    @property
    def pending(self) -> int:
        return self._w.pending

    def close(self) -> int:
        return self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_state_history(path):
    """Read back a :class:`StateHistoryWriter` file: a dict with one
    ``(n_frames, capacity)`` array per ray field (``active`` as bool), and
    ``u``/``v`` as ``(n_frames, n_cell)``."""
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    layout = meta["state_layout"]
    cap, nc = layout["capacity"], layout["n_cell"]
    flat = read_history(path)
    out = {}
    off = 0
    for name in layout["ray_fields"]:
        block = flat[:, off:off + cap]
        out[name] = block != 0 if name == "active" else block
        off += cap
    for name in layout["mean_fields"]:
        out[name] = flat[:, off:off + nc]
        off += nc
    return out
