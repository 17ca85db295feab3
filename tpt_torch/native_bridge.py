"""ctypes bridge to the native C++ runtime components (port of
tpt.native_bridge).

Builds the port's own copy of the C++ source, ``tpt_torch/native/
tptnative.cpp``, into a shared library at first use (``g++ -O2 -fPIC
-shared ... -lz``) under ``tpt_torch/_build/native/<hash of the source and
flags>/``, written to a temporary name and renamed into place, and exposes:

  * :func:`pack_std140_native` / :func:`unpack_std140_native`
  * :func:`pcg_floats_native` — the shader's PCG chain, bit for bit
  * :func:`write_png_native` — a zlib PNG encoder with the GL vertical flip

Every entry point has a pure-Python version (tpt_torch.scene, tpt_torch.rng,
tpt_torch.utils.image) that runs when no compiler or zlib is there; this is
host code off the device path.  :func:`native_available` says which runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .config import MAX_CUBOIDS, MAX_SPHERES
from .scene import STD140_TOTAL_FLOATS

PACKAGE_DIR = Path(__file__).resolve().parent
SRC = PACKAGE_DIR / "native" / "tptnative.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared")
LIBS = ("-lz",)

_lock = threading.Lock()
_lib = None
_build_error = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return PACKAGE_DIR / "_build" / "native" / h.hexdigest()[:16] / "libtptnative.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC), *LIBS], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError) as e:   # no g++, no zlib
            _build_error = e
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.tpt_pack_std140.restype = ctypes.c_int
        lib.tpt_pack_std140.argtypes = [f32p, f32p, ctypes.c_int, f32p, f32p, f32p,
                                        ctypes.c_int, f32p]
        lib.tpt_unpack_std140.restype = ctypes.c_int
        lib.tpt_unpack_std140.argtypes = [f32p] + [f32p] * 5
        lib.tpt_pcg_floats.restype = None
        lib.tpt_pcg_floats.argtypes = [ctypes.c_uint32, ctypes.c_int, f32p]
        lib.tpt_write_png.restype = ctypes.c_int
        lib.tpt_write_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library built and loaded (else the Python
    versions run)."""
    return _load() is not None


def build_error():
    """Why the native library is not available, or None."""
    _load()
    return _build_error


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _host(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)


def pack_std140_native(scene) -> np.ndarray:
    lib = _load()
    if lib is None:
        from .scene import pack_std140
        return pack_std140(scene)
    spheres, smats = _host(scene.sphere_pos_radius), _host(scene.sphere_material)
    cmin, cmax = _host(scene.cuboid_min), _host(scene.cuboid_max)
    cmats = _host(scene.cuboid_material)
    out = np.zeros(STD140_TOTAL_FLOATS, np.float32)
    rc = lib.tpt_pack_std140(_f32p(spheres), _f32p(smats), MAX_SPHERES, _f32p(cmin),
                             _f32p(cmax), _f32p(cmats), MAX_CUBOIDS, _f32p(out))
    if rc != 0:
        raise RuntimeError(f"tpt_pack_std140 failed: {rc}")
    return out


def unpack_std140_native(buf: np.ndarray):
    """Returns (spheres [256,4], smats [256,16], cmin, cmax, cmats) arrays."""
    lib = _load()
    buf = np.ascontiguousarray(buf, np.float32)
    if buf.size != STD140_TOTAL_FLOATS:
        raise ValueError(f"expected {STD140_TOTAL_FLOATS} floats")
    if lib is None:
        from .scene import unpack_std140
        s = unpack_std140(buf, MAX_SPHERES, MAX_CUBOIDS)
        return tuple(_host(getattr(s, f)) for f in ("sphere_pos_radius", "sphere_material",
                                                    "cuboid_min", "cuboid_max",
                                                    "cuboid_material"))
    spheres = np.zeros((MAX_SPHERES, 4), np.float32)
    smats = np.zeros((MAX_SPHERES, 16), np.float32)
    cmin = np.zeros((MAX_CUBOIDS, 3), np.float32)
    cmax = np.zeros((MAX_CUBOIDS, 3), np.float32)
    cmats = np.zeros((MAX_CUBOIDS, 16), np.float32)
    lib.tpt_unpack_std140(_f32p(buf), _f32p(spheres), _f32p(smats), _f32p(cmin),
                          _f32p(cmax), _f32p(cmats))
    return spheres, smats, cmin, cmax, cmats


def pcg_floats(seed: int, n: int) -> np.ndarray:
    """The Python version of :func:`pcg_floats_native`: ``n`` sequential
    draws of tpt_torch.rng from ``seed``."""
    import torch
    from .rng import MASK32, random_float01
    s = torch.tensor(seed & MASK32, dtype=torch.int64)
    out = np.zeros(n, np.float32)
    for i in range(n):
        value, s = random_float01(s)
        out[i] = value.item()
    return out


def pcg_floats_native(seed: int, n: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        return pcg_floats(seed, n)
    out = np.zeros(n, np.float32)
    lib.tpt_pcg_floats(ctypes.c_uint32(seed & 0xFFFFFFFF), n, _f32p(out))
    return out


def write_png_native(path: str, image_gl_rows) -> None:
    """Write RGB PNG from GL-row-ordered float [0,1] or uint8 image."""
    img = np.asarray(image_gl_rows)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    img = np.ascontiguousarray(img[:, :, :3])
    lib = _load()
    if lib is None:
        from .utils.image import write_png
        write_png(path, img)
        return
    h, w = img.shape[:2]
    rc = lib.tpt_write_png(path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                           w, h)
    if rc != 0:
        raise RuntimeError(f"tpt_write_png failed: {rc}")
