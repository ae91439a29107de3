"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into an
object file, all sources at once in parallel, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``_build/`` beside this file (listed in
``.gitignore``), under a name that hashes the sources, the headers they share
(``csrc/*.cuh``) and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. Only the sources in the package are used.
A failed ``nvcc`` raises with its output.

``--fmad=false`` keeps nvcc from contracting a multiply and an add into one
FMA: the remove_doubling scan (K2) must round exactly as the plain PyTorch
version's separate operations do, because it decides pitch indices. The
spectra kernels write every multiply-add they want fused as ``__fmaf_rn``,
which the flag leaves alone: the FFT butterflies of K4-K6, K4 and K5's band
sums, K6's overlap-add.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each exported launcher: pointers and the stream as c_void_p,
# sizes and the device index as c_int.
_SIGNATURES = {
    "crispy_nn_scan_f32": [_P] * 23 + [_I, _I, _I, _P],
    "crispy_nn_scan_resident": [_P] * 15 + [_I, _I, _I, _I, _P],
    "crispy_rd_scan": [_P] * 6 + [_I, _I, _I, _P],
    "crispy_pitch_gather": [_P] * 3 + [_I, _I, _I, _I, _P],
    "crispy_spectrum_bands": [_P, _I, _I, _I, _I] + [_P] * 5 + [_I, _P],
    "crispy_inv_spectrum_ola": [_P] * 7 + [_I, _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
# First uses may race (request threads of the web server): one builds and
# binds, the others wait and take its library.
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc", shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> List[Path]:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {SRC_DIR}")
    return srcs


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcrispy_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of these sources exists; returns
    its path. The build log (ptxas register and shared-memory report) is
    written beside it as ``build.log``."""
    lib = _library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        jobs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        out_so = tmp / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_so), *[str(o) for _, o, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        os.replace(out_so, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
