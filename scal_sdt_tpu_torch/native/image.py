"""The native image pipeline (port of ``scal_sdt_tpu/native/image.py``).

One C call decodes (DCT-scaled for JPEG), cover-resizes with Lanczos-3,
crops and normalizes to float32 [-1, 1]: the host-side hot path of the
uncached input pipeline. ctypes releases the GIL during the call, so the
pipeline's thread pool decodes in parallel.

The source is the package's own copy of the JAX package's
``native/ssdt_image.cpp`` (``csrc/ssdt_image.cpp``, byte for byte). It is
compiled on first use by one ``g++`` call with the flags of
``native/Makefile`` into ``build/`` (listed in ``.gitignore``), under a name
keyed by a hash of the source, the flags and the host CPU's model and
feature flags (``-march=native`` builds for this CPU), so neither an edited
source nor another machine reuses a stale build. ``available()`` is False
when the compiler, libjpeg or libpng is missing; the dataset then decodes
with PIL, as the JAX package does when its library is not built. Which decoder is active is logged once
per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).parent / "csrc" / "ssdt_image.cpp"
BUILD_DIR = Path(__file__).parent / "build"
# native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng")

logger = logging.getLogger("native_image")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error = ""   # why the build failed, when it did


def _cpu_id() -> bytes:
    """The lines of /proc/cpuinfo that ``-march=native`` depends on."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = ("model name", "flags", "vendor_id", "cpu family", "model\t")
    return "\n".join(sorted({ln for ln in lines if ln.startswith(keep)})).encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_id())
    return BUILD_DIR / f"libssdt_image_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(lib), str(SOURCE), *LDLIBS],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stdout}")
        os.replace(lib, out)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.ssdt_decode_resize_crop.restype = ctypes.c_int
    lib.ssdt_decode_resize_crop.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
    ]
    lib.ssdt_image_size.restype = ctypes.c_int
    lib.ssdt_image_size.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call of the process; None when it
    cannot be built."""
    global _lib, _tried, build_error
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                out = library_path()
                if not out.exists():
                    _compile(out)
                _lib = _bind(out)
                logger.info(f"images decode through the native decoder ({out.name})")
            except (RuntimeError, OSError) as e:
                build_error = str(e)
                logger.info(f"images decode through PIL: the native decoder did not build "
                            f"({build_error.splitlines()[0] if build_error else 'unknown'})")
            _tried = True
    return _lib


def available() -> bool:
    return _load() is not None


def decoder_name() -> str:
    """'native' or 'pil': the decoder the uncached datasets use."""
    return "native" if available() else "pil"


def decode_resize_crop(path, target_w: int, target_h: int,
                       crop_x_frac: float = 0.5, crop_y_frac: float = 0.5
                       ) -> Optional[np.ndarray]:
    """-> (target_h, target_w, 3) float32 in [-1, 1], or None on failure
    (an unsupported format: the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    data = Path(path).read_bytes()
    out = np.empty((target_h, target_w, 3), np.float32)
    rc = lib.ssdt_decode_resize_crop(
        data, len(data), target_w, target_h,
        float(crop_x_frac), float(crop_y_frac),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def image_size(path) -> Optional[tuple[int, int]]:
    """(w, h) from the headers without a full decode, or None."""
    lib = _load()
    if lib is None:
        return None
    data = Path(path).read_bytes()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.ssdt_image_size(data, len(data), ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None
