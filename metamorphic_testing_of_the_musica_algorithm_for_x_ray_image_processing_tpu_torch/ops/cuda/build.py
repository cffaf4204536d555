"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

At first use every ``*.cu`` file under the package's ``csrc/`` is compiled
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds).  The library lands in ``build/kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing is built or
imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -fmad=false: no FMA contraction anywhere in the kernels (bin decisions,
# QUIRKS #29); never --use_fast_math (the /0.1 division must be correctly
# rounded, QUIRKS #7).  -Xptxas=-v reports registers and shared memory.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "musica_error_string": ([_I], ctypes.c_char_p),
    "musica_noise_hist": ([ctypes.POINTER(_VP), ctypes.POINTER(_I),
                           ctypes.POINTER(_I), ctypes.POINTER(_I), _I, _VP,
                           _I, _I, ctypes.c_float, _VP], _I),
    "musica_hist_argmax": ([_VP, _I, _I, _VP, _VP], _I),
    "musica_grad_hist": ([_VP, _VP, _I, _I, _VP, _I, _I, _VP], _I),
    "musica_grad_hist_relevant": ([_VP, _VP, _I, _I, _VP, _I, _I, _I,
                                   ctypes.c_float, _VP, _I, _I, _VP], _I),
}

_LIB = None  # the loaded library handle


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmusica_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists; returns
    its path.  Raises with the compiler's output if the build fails.  The
    compiler's messages (ptxas register and shared-memory report) are kept
    beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    Path(str(out) + ".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def build_log() -> str:
    p = Path(str(library_path()) + ".log")
    return p.read_text() if p.exists() else ""


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB
