"""The native image pipeline (port of ``scal_sdt_tpu/native/image.py``).

One C call decodes (DCT-scaled for JPEG), cover-resizes with Lanczos-3,
crops and normalizes to float32 [-1, 1]: the host-side hot path of the
uncached input pipeline. ctypes releases the GIL during the call, so the
pipeline's thread pool decodes in parallel.

The source is the package's own copy of the JAX package's
``native/ssdt_image.cpp`` (``csrc/ssdt_image.cpp``, byte for byte). It is
compiled on first use by one ``g++`` call with the flags of
``native/Makefile`` into ``build/`` (listed in ``.gitignore``). Builds are
tried in order until one succeeds (``builds()``):

* ``system``: the Makefile's own, ``-ljpeg -lpng`` against the system's
  headers and ``-dev`` symlinks;
* ``kept-headers+pillow``, where the host has no libjpeg / libpng headers:
  the libjpeg-turbo 62 and libpng16 headers kept in ``include/`` (their
  licences beside them), linked by full path, with an rpath, to the shared
  objects of Pillow's wheel, ``pillow.libs/`` (found from ``PIL.__file__``).

A build's file name is keyed by a hash of the source, the flags, the
libraries it links (their paths and bytes) and the host CPU's model and
feature flags (``-march=native`` builds for this CPU), so neither an edited
source nor another machine or library reuses a stale build. A build that
fails leaves its error beside that name (``.failed``), so later processes
on the host skip it without running ``g++`` again; delete ``build/`` to
retry. ``available()`` is False when no build succeeds (no compiler, or no
headers and no Pillow wheel libraries); the dataset then decodes with PIL,
as the JAX package does when its library is not built. Which decoder is
active, and which build, is logged once per process.
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
from typing import NamedTuple, Optional

import numpy as np

SOURCE = Path(__file__).parent / "csrc" / "ssdt_image.cpp"
BUILD_DIR = Path(__file__).parent / "build"
INCLUDE_DIR = Path(__file__).parent / "include"
# native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng")
# the runtime libraries in Pillow's wheel: (file name prefix, major version)
_RUNTIME = (("libjpeg-", "62"), ("libpng16-", "16"))

logger = logging.getLogger("native_image")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error = ""   # why each build tried before the active one (or every build) failed
active_build = ""  # the name of the build in use ("" when PIL decodes)


class Build(NamedTuple):
    """One way to build the library: ``flags`` go before the source,
    ``link`` after it; ``libraries`` are the shared objects it links by
    path (their bytes key the build)."""
    name: str
    flags: tuple[str, ...]
    link: tuple[str, ...]
    libraries: tuple[Path, ...] = ()


def _cpu_id() -> bytes:
    """The lines of /proc/cpuinfo that ``-march=native`` depends on."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = ("model name", "flags", "vendor_id", "cpu family", "model\t")
    return "\n".join(sorted({ln for ln in lines if ln.startswith(keep)})).encode()


SYSTEM_BUILD = Build("system", (), LDLIBS)


def pillow_libraries() -> Optional[tuple[Path, Path]]:
    """(libjpeg 62, libpng16) of Pillow's wheel (``pillow.libs/`` beside the
    ``PIL`` package), or None."""
    try:
        import PIL
    except ImportError:
        return None
    root = Path(PIL.__file__).resolve().parent.parent
    found = []
    for prefix, major in _RUNTIME:
        # auditwheel names them e.g. libjpeg-18a3f47f.so.62.4.0
        hits = sorted(p for d in ("pillow.libs", "Pillow.libs") if (root / d).is_dir()
                      for p in (root / d).iterdir()
                      if p.name.startswith(prefix) and f".so.{major}" in p.name)
        if not hits:
            return None
        found.append(hits[0])
    return found[0], found[1]


def kept_headers_build(libraries: tuple[Path, Path],
                       name: str = "kept-headers+pillow") -> Build:
    """The build against ``include/``, linking ``libraries`` (libjpeg 62,
    libpng16) by full path with an rpath to their directories."""
    dirs = sorted({str(Path(p).resolve().parent) for p in libraries})
    return Build(name, ("-I", str(INCLUDE_DIR)),
                 tuple(str(Path(p).resolve()) for p in libraries)
                 + tuple(f"-Wl,-rpath,{d}" for d in dirs),
                 tuple(Path(p).resolve() for p in libraries))


def builds() -> list[Build]:
    """The builds to try, in order: the system's, then the kept headers
    against Pillow's libraries where Pillow's wheel has them."""
    libs = pillow_libraries()
    return [SYSTEM_BUILD] + ([kept_headers_build(libs)] if libs is not None else [])


def library_path(build: Build = SYSTEM_BUILD) -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + build.flags + build.link).encode())
    h.update(SOURCE.read_bytes())
    for lib in build.libraries:
        h.update(Path(lib).read_bytes())
    h.update(_cpu_id())
    return BUILD_DIR / f"libssdt_image_{h.hexdigest()[:16]}.so"


def _compile(out: Path, build: Build = SYSTEM_BUILD) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        proc = subprocess.run([cxx, *CXXFLAGS, *build.flags, "-shared", "-o", str(lib),
                               str(SOURCE), *build.link],
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


def failure_path(build: Build = SYSTEM_BUILD) -> Path:
    """Where a failed build of ``build`` leaves its error."""
    return library_path(build).with_suffix(".failed")


def load_build(build: Build) -> ctypes.CDLL:
    """The library of ``build``, compiled unless this host has it already;
    raises, without compiling, where the build failed before."""
    out, failed = library_path(build), failure_path(build)
    if not out.exists():
        if failed.exists():
            raise RuntimeError(failed.read_text())
        try:
            _compile(out, build)
        except RuntimeError as e:
            failed.parent.mkdir(parents=True, exist_ok=True)
            tmp = failed.with_name(f"{failed.name}.{os.getpid()}")
            tmp.write_text(str(e))
            os.replace(tmp, failed)
            raise
    return _bind(out)


def _load() -> Optional[ctypes.CDLL]:
    """The library of the first build that succeeds, built on the first call
    of the process; None when none can be built."""
    global _lib, _tried, build_error, active_build
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            errors = []
            for build in builds():
                try:
                    _lib = load_build(build)
                except (RuntimeError, OSError) as e:
                    errors.append(f"{build.name}: {e}")
                    continue
                active_build = build.name
                logger.info(f"images decode through the native decoder ({build.name} build, "
                            f"{library_path(build).name})")
                break
            build_error = "\n".join(errors)
            if _lib is None:
                first = errors[0].splitlines()[0] if errors else "unknown"
                logger.info(f"images decode through PIL: the native decoder did not build "
                            f"({first})")
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
