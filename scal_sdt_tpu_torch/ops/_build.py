"""Build and load the port's CUDA kernels on first use.

Each source under ``ops/csrc`` is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``, then linked into one shared library with a
plain C interface that ``ctypes`` loads (no PyTorch headers: the build takes
seconds, not minutes). The library lands in ``ops/build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so an
edited source never reuses a stale build. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("splash_fwd.cu", "splash_bwd.cu", "adam8_fused.cu", "adam_bf16_fused.cu",
           "ema_fused.cu")
HEADERS = ("splash_common.cuh", "splash_hopper.cuh", "wgmma.cuh", "adam_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
# C entry points and their argument types (see the extern "C" blocks).
_SIGNATURES = {
    "ssdt_splash_fwd": [_P] * 5 + [_I] * 5 + [_LL, _P],
    "ssdt_splash_dq": [_P] * 8 + [_I] * 5 + [_LL, _LL, _P],
    "ssdt_splash_dkv": [_P] * 8 + [_I] * 5 + [_LL, _LL, _P],
    "ssdt_adam8_fused": [_P] * 6 + [_I] * 4 + [_F] * 7 + [_P],
    "ssdt_adam_bf16_fused": ([_P] * 4 + [ctypes.c_longlong] + [_I] * 4 + [_F] * 7
                             + [_I, _I, _I, ctypes.c_uint, _P]),
    "ssdt_adam_bf16_group": ([_P] * 4 + [_I, ctypes.c_longlong] + [_I] * 5 + [_F] * 5
                             + [_I, _I, _I, _P]),
    "ssdt_adam8_group": ([_P] * 3 + [_I] * 5 + [_F] * 7
                         + [_I, _F, _F, ctypes.c_uint, _P]),
    "ssdt_ema_group": [_P, _P, _I, ctypes.c_longlong, _I, _I, _I, _F, ctypes.c_uint, _P],
}

_library: ctypes.CDLL | None = None
build_log = ""   # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, csrc: Path = CSRC, sources: tuple[str, ...] = SOURCES) -> str:
    """Compile ``sources`` of ``csrc`` into the shared library ``out``;
    returns nvcc's output."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(csrc / s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = []
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate()
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, out)
    return "\n".join(logs)


def bind(path: Path, names=tuple(_SIGNATURES)) -> ctypes.CDLL:
    """Load a built library and declare its C entry points ``names`` (and
    ``ssdt_error_string``, which every library holds)."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.ssdt_error_string.argtypes = [ctypes.c_int]
    lib.ssdt_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call of the process."""
    global _library, build_log
    if _library is None:
        out = BUILD_DIR / f"libssdt_kernels_{_key()}.so"
        if not out.exists():
            build_log = _compile(out)
        _library = bind(out)
    return _library


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned an error code."""
    if err != 0:
        msg = lib.ssdt_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed ({err}): {msg}")
