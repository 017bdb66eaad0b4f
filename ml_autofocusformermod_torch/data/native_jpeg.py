"""ctypes bindings for the native decode/resample runtime (the port's copy of
the JAX package's ``data/native_jpeg.py``).

``native/src/affdata.cpp`` implements the hot half of the input pipeline:
JPEG decode with DCT-domain downscale and scanline cropping, a
Pillow-equivalent separable resampler and the RandAugment ops. It is built
at first use with ``g++ ... -ljpeg`` into ``native/build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, the flags
and the host's CPU model, so an edited source is rebuilt and an unchanged
one reused; nothing is written into the package's source tree and nothing
is built at import.
Where the build fails (no g++, no libjpeg headers) or
``MLAFF_NO_NATIVE_DATA=1``, every function returns None (or False) and the
callers decode with Pillow; :func:`build_info` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "build_info", "get_lib", "jpeg_dims",
           "decode_crop_resize", "randaugment_inplace", "resample_rgb"]

NATIVE = Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE / "src" / "affdata.cpp"
BUILD_DIR = NATIVE / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-march=native", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[dict] = None


def _cpu_model() -> str:
    """The host CPU's model line: ``-march=native`` code built for one CPU
    may not run on another, so the library's name depends on it."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("model name")), "")
    except OSError:
        return ""


def _target() -> Path:
    cxx = os.environ.get("CXX", "g++")
    key = " ".join((cxx,) + CXX_FLAGS) + _cpu_model()
    digest = hashlib.sha1(SOURCE.read_bytes() + key.encode()).hexdigest()
    return BUILD_DIR / f"libaffdata.{digest[:16]}.so"


def _build(target: Path) -> dict:
    """Compile the library into ``target``; a dict for :func:`build_info`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-ljpeg",
           "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"ok": False, "seconds": time.perf_counter() - t0,
                "error": f"{type(e).__name__}: {e}"}
    info = {"ok": res.returncode == 0, "seconds": time.perf_counter() - t0,
            "returncode": res.returncode}
    if res.returncode == 0:
        os.replace(tmp, target)
    else:
        info["stderr_tail"] = res.stderr[-2000:]
        tmp.unlink(missing_ok=True)
    return info


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.aff_version.restype = ctypes.c_int
    lib.aff_version.argtypes = []
    lib.aff_jpeg_dims.restype = ctypes.c_int
    lib.aff_jpeg_dims.argtypes = [
        u8p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.aff_jpeg_decode_resample.restype = ctypes.c_int
    lib.aff_jpeg_decode_resample.argtypes = [
        u8p, ctypes.c_long,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u8p,
    ]
    lib.aff_resample_rgb.restype = ctypes.c_int
    lib.aff_resample_rgb.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
    ]
    lib.aff_randaugment.restype = ctypes.c_int
    lib.aff_randaugment.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on the first call of the
    process; None when it cannot be built or loaded."""
    global _lib, _info
    if _info is not None:
        return _lib
    with _lock:
        if _info is not None:
            return _lib
        if os.environ.get("MLAFF_NO_NATIVE_DATA", "0") == "1":
            _info = {"ok": False, "error": "MLAFF_NO_NATIVE_DATA=1"}
            return None
        target = _target()
        info = ({"ok": True, "seconds": 0.0, "cached": True}
                if target.exists() else dict(_build(target), cached=False))
        lib = None
        if info["ok"]:
            try:
                lib = ctypes.CDLL(str(target))
                _bind(lib)
                if lib.aff_version() != 1:
                    info.update(ok=False, error="aff_version() != 1")
                    lib = None
            except OSError as e:
                info.update(ok=False, error=f"OSError: {e}")
                lib = None
        info["path"] = str(target)
        _lib, _info = lib, info
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_info() -> dict:
    """How the library was obtained in this process: ``ok``, ``cached``,
    ``seconds``, ``path``, and on failure ``error`` or the compiler's
    ``returncode`` and ``stderr_tail``."""
    get_lib()
    return dict(_info)


_FILTERS = {"bilinear": 0, "bicubic": 1}


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None if not decodable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    if lib.aff_jpeg_dims(_u8ptr(buf), len(data), ctypes.byref(w),
                         ctypes.byref(h)):
        return None
    return w.value, h.value


def decode_crop_resize(
    data: bytes,
    box: Tuple[float, float, float, float],  # (x, y, w, h) original coords
    out_size: Tuple[int, int],               # (w, h)
    flip: bool = False,
    interpolation: str = "bicubic",
    fast_scale: bool = True,
) -> Optional[np.ndarray]:
    """Decode JPEG bytes, crop ``box``, resample to ``out_size``.

    Returns (h, w, 3) uint8 RGB, or None on failure (the caller falls back
    to Pillow). Matches ``PIL.Image.resize(size, interp, box=box)``
    numerics; ``fast_scale`` enables DCT-domain downscale (the train path;
    about 1 LSB off a full decode on photographs); eval passes False.
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    ow, oh = out_size
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.aff_jpeg_decode_resample(
        _u8ptr(buf), len(data),
        float(box[0]), float(box[1]), float(box[2]), float(box[3]),
        int(ow), int(oh), int(bool(flip)),
        _FILTERS.get(interpolation, 1), int(bool(fast_scale)), _u8ptr(out),
    )
    return None if rc else out


def randaugment_inplace(arr: np.ndarray, op_ids, params) -> bool:
    """Execute a pre-drawn RandAugment plan in place on (h, w, 3) uint8.

    ``op_ids``/``params`` come from ``RandAugment.plan`` mapped through
    ``transforms.RA_OP_IDS``. Returns False if the native runtime is
    unavailable (the caller runs the Pillow executor on the SAME plan, so
    the rng stream never diverges).
    """
    lib = get_lib()
    if lib is None or not op_ids:
        return lib is not None and not op_ids
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3 \
            or not arr.flags.c_contiguous:
        raise ValueError("randaugment_inplace needs a C-contiguous "
                         "(h, w, 3) uint8 array")
    ids = (ctypes.c_int * len(op_ids))(*op_ids)
    ps = (ctypes.c_double * len(params))(*params)
    rc = lib.aff_randaugment(
        _u8ptr(arr), arr.shape[1], arr.shape[0], ids, ps, len(op_ids)
    )
    return rc == 0


def resample_rgb(
    arr: np.ndarray,
    box: Tuple[float, float, float, float],
    out_size: Tuple[int, int],
    flip: bool = False,
    interpolation: str = "bicubic",
) -> Optional[np.ndarray]:
    """Native crop+resample of an in-memory (h, w, 3) uint8 RGB array."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    ow, oh = out_size
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.aff_resample_rgb(
        _u8ptr(arr), arr.shape[1], arr.shape[0],
        float(box[0]), float(box[1]), float(box[2]), float(box[3]),
        int(ow), int(oh), int(bool(flip)),
        _FILTERS.get(interpolation, 1), _u8ptr(out),
    )
    return None if rc else out
