"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, into an object file for ``sm_90a``; the objects are then linked
into one shared library with a plain C interface, which ``ctypes`` loads.
Nothing includes PyTorch's headers, so a build takes seconds, not the
minutes of ``torch.utils.cpp_extension``.

The build runs at first use, into ``ops/_build/`` (listed in .gitignore),
under a name that hashes the sources and flags, so a changed source is
rebuilt and an unchanged one is reused within a checkout.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("mont_mul.cu", "ec_add_g1.cu", "ec_add_g2.cu", "ntt_fr.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_N = ctypes.c_longlong
# C signatures of the launchers; each returns its launch's cudaError_t
SIGNATURES = {
    "zk_mont_mul": [_P, _P, _P, _N, ctypes.c_int, _P],
    "zk_ec_add_g1": [_P] * 10 + [_N, _P],
    "zk_ec_add_g2": [_P] * 19 + [_N, _P],
    "zk_ntt_pass": [_P] * 6 + [ctypes.c_int] * 3 + [_N, _P],
}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
            "from ops/csrc at first use on a machine with the CUDA toolkit"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if needed; returns the shared library's path.

    The compilers' output (``-Xptxas -v``: registers, spills and stack of
    every kernel) is kept beside the library as ``ptxas.log``."""
    lib = BUILD_DIR / f"libzk_kernels_{_digest()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + f"_{os.getpid()}.o")
        cmd = [nvcc, *ARCH_FLAGS, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    log_text = "\n".join(logs)
    (BUILD_DIR / "ptxas.log").write_text(log_text)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log_text}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        check=True, capture_output=True, text=True,
    )
    os.replace(tmp, lib)
    for _, obj, _ in procs:
        obj.unlink()
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ptxas_log() -> str:
    """What ptxas reported for the last build (registers, spills, stack)."""
    path = BUILD_DIR / "ptxas.log"
    return path.read_text() if path.is_file() else ""
