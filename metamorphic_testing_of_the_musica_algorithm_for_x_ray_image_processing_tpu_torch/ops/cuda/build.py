"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

At first use every ``*.cu`` file under the package's ``csrc/`` is compiled
(one ``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds).  The library lands in ``build/kernels/`` at the root of the
checkout, named by a hash of the sources, the headers beside them and the
flags, so an edited file is rebuilt and an unchanged one is loaded as it is.
Nothing is built or imported when this module is imported.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "musica_error_string": ([_I], ctypes.c_char_p),
    "musica_noise_hist": ([ctypes.POINTER(_VP), ctypes.POINTER(_I),
                           ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_I),
                           ctypes.POINTER(_I), _I, _VP, _VP, _VP, _I, _I, ctypes.c_float,
                           _VP], _I),
    "musica_hist_argmax": ([_VP, _I, _I, _VP, _VP], _I),
    "musica_grad_hist": ([_VP, _VP, _I, _I, _I, _I, _VP, _I, _I, _VP], _I),
    "musica_grad_hist_relevant": ([_VP, _VP, _I, _I, _I, _I, _VP, _VP, _I, _I, _I, _I, _I,
                                   *[ctypes.c_float] * 4, _I, _VP, _I, _I, _VP], _I),
    "musica_clahe_hist": ([_VP, _VP, _I, _I, _I, _VP, _VP, _I, _I, _I, _I,
                           *[ctypes.c_float] * 4, _I, _I, _I, _VP, _VP], _I),
    "musica_clahe_curves": ([_VP, _I, _I, ctypes.c_float, _VP, _VP, _VP], _I),
    "musica_histogram": ([_VP, _VP, ctypes.c_longlong, _VP, _I, _VP], _I),
    "musica_clahe_apply": ([_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP], _I),
    "musica_sdev_noise_hist": ([ctypes.POINTER(_VP), ctypes.POINTER(_VP),
                                *[ctypes.POINTER(_I)] * 6, _I, _VP, _VP, _VP, _I, _I,
                                ctypes.c_float, _I, _VP], _I),
    "musica_sdev": ([ctypes.POINTER(_VP), ctypes.POINTER(_VP), *[ctypes.POINTER(_I)] * 5, _I,
                     _I, _VP], _I),
    "musica_sdev_tail": ([_VP, _VP, ctypes.c_longlong, _I, _VP], _I),
    "musica_contrast_apply": ([_VP, _I, _I, ctypes.c_float, ctypes.c_float, ctypes.c_float, _VP],
                              _I),
    "musica_normalize_extrema": ([_VP, _I, ctypes.c_longlong, _VP, _I, _VP], _I),
    "musica_normalize_apply": ([_VP, _I, ctypes.c_longlong, _VP, _VP, _VP, _I, _I, _I, _I, _VP,
                                _VP], _I),
    "musica_gradation_curve": ([_VP, _I, _I, *[ctypes.c_float] * 5, _VP, _VP], _I),
    "musica_tone_map": ([_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP], _I),
    "musica_reduce_step": ([_VP, _I, _I, _I, _I, _VP, _I, _I, _VP, _I, _VP], _I),
    "musica_upsample_smooth": ([_VP, _I, _I, _I, _VP, _I, _I, _I, _VP, _I, _VP], _I),
    "musica_reduce_tail": ([_VP, _I, _I, ctypes.POINTER(_VP), ctypes.POINTER(_VP), _VP], _I),
    "musica_expand_tail": ([_VP, _I, _I, ctypes.POINTER(_VP), _I, _VP, _VP], _I),
}

_LIB = None  # the loaded library handle


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def headers():
    return sorted(SRC_DIR.glob("*.cuh"))


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
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmusica_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once, wait for all of them; returns
    ``[(cmd, returncode, output)]``."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [p.communicate()[0] for p in procs]
    return [(cmd, p.returncode, text) for cmd, p, text in zip(cmds, procs, outputs)]


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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in srcs]
        lib = str(Path(tmp) / out.name)
        log = ""
        for cmds in ([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                      for obj, src in zip(objs, srcs)],
                     [[nvcc, *ARCH, "-shared", "-o", lib, *objs]]):
            for cmd, rc, text in _run_all(cmds):
                log += text
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
        Path(str(out) + ".log").write_text(log)
        os.replace(lib, out)  # atomic: a concurrent build never sees a partial file
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
