"""ctypes binding for the native JPEG decode + resize library
(`imageclassification_tpu_torch/native/decode.cpp`, the port's copy of the
JAX package's decoder: the same code, so both packages feed the same pixels).

Built with g++ at first use, with the JAX package's flags, into
`build/native/` at the root of the checkout (listed in .gitignore). The
library's file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded; nothing is built next
to the source. Every decode call releases the GIL (ctypes), so the
`BatchLoader`'s thread pool decodes on every core. Where g++ or libjpeg is
missing, or the library does not load (one built on another host and
copied with the checkout, whose libjpeg this host lacks), the error is
printed once and `loader.decode_image` decodes through PIL, as the JAX
loader does where its library does not build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the JAX package's build line (data/native_decode.py there), less the output
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-ljpeg",)

BILINEAR = 1
BICUBIC = 2

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libimgdecode-{digest.hexdigest()[:12]}.so"


def _build() -> Optional[str]:
    """Compile decode.cpp unless its library is there; None on success, else
    the error."""
    out = library_path()
    if out.exists():
        return None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: another process never loads half a file
        return None
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain or no libjpeg
        detail = getattr(e, "stderr", b"") or b""
        return f"{e}; {detail.decode(errors='replace').strip()[:500]}"


def get_lib():
    """The native library, built first if needed; None where it does not
    build or load.

    `_tried` is set only after the load has resolved, inside the lock: a
    first use from several of the loader's threads at once blocks on the
    lock instead of seeing a half-initialised state and falling back to PIL
    (which decodes slightly differently: batches would not repeat)."""
    global _lib, _tried, _error
    if _lib is not None:
        return _lib
    if _tried:  # resolved to 'unavailable'
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _error = _build()
        if _error is None:
            try:
                lib = ctypes.CDLL(str(library_path()))
            except OSError as e:  # built, but a library it needs is not found
                _error = f"load failed: {e}"
        if _error is not None:
            print(f"native decoder build failed ({_error}); using PIL decode")
            _tried = True
            return None
        lib.jpeg_dims.restype = ctypes.c_int
        lib.jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.decode_crop_resize.restype = ctypes.c_int
        lib.decode_crop_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library did not build (after `get_lib` returned None), else None."""
    return _error


def jpeg_dims(data: bytes):
    """(width, height) of a JPEG from its header; None where libjpeg refuses it."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_crop_resize(data: bytes, crop, out_size: int,
                       filter: int = BICUBIC) -> Optional[np.ndarray]:
    """crop = (x, y, w, h) in original coordinates (w/h = -1: the whole
    image); uint8 [out_size, out_size, 3], or None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((out_size, out_size, 3), np.uint8)
    cx, cy, cw, ch = crop
    rc = lib.decode_crop_resize(
        data, len(data), cx, cy, cw, ch, out_size, filter,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out if rc == 0 else None
