"""ctypes bindings and build glue for the native Groth16 verifier.

The port of ``zkemail_tpu/native/verifier.py``. ``groth16_verifier.cpp``
(with ``bn254_constants.h``, copies of the JAX package's) is compiled with
``g++`` at first use into ``native/_build/`` (listed in .gitignore), not
beside the source, and rebuilt when the source is newer than the library.
``verify(vk, proof, publics)`` takes the same containers as the Python
oracle ``prover.containers.verify``. A missing ``g++`` is an error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

from ..core.curve import G1, G2
from ..prover.containers import Proof, VerifyingKey

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "groth16_verifier.cpp"
BUILD_DIR = _DIR / "_build"
_SO = BUILD_DIR / "libgroth16.so"

_lib = None


def build(force: bool = False) -> Path:
    """Compile the verifier library if it is missing or older than its
    sources; returns its path."""
    newest = max(_SRC.stat().st_mtime, (_DIR / "bn254_constants.h").stat().st_mtime)
    if _SO.exists() and not force and _SO.stat().st_mtime >= newest:
        return _SO
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native verifier is built from "
                           "native/groth16_verifier.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, "-O2", "-fPIC", "-shared", "-std=c++17", str(_SRC), "-o", str(tmp)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name}:\n{out.stderr}")
    os.replace(tmp, _SO)
    return _SO


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.groth16_verify.restype = ctypes.c_int
        lib.groth16_verify.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int,
        ]
        _lib = lib
    return _lib


def _g1_bytes(p: G1) -> bytes:
    if p.inf:
        return b"\x00" * 64
    return p.x.to_bytes(32, "little") + p.y.to_bytes(32, "little")


def _g2_bytes(p: G2) -> bytes:
    if p.inf:
        return b"\x00" * 128
    return (
        p.x.c0.to_bytes(32, "little") + p.x.c1.to_bytes(32, "little")
        + p.y.c0.to_bytes(32, "little") + p.y.c1.to_bytes(32, "little")
    )


def vk_bytes(vk: VerifyingKey) -> bytes:
    """The flat-affine verifying key the C ABI takes."""
    return (
        _g1_bytes(vk.alpha_g1) + _g2_bytes(vk.beta_g2) + _g2_bytes(vk.gamma_g2)
        + _g2_bytes(vk.delta_g2) + b"".join(_g1_bytes(p) for p in vk.ic)
    )


def proof_bytes(proof: Proof) -> bytes:
    return _g1_bytes(proof.a) + _g2_bytes(proof.b) + _g1_bytes(proof.c)


def publics_bytes(publics: list[int]) -> bytes:
    return b"".join((x % (1 << 256)).to_bytes(32, "little") for x in publics)


def verify(vk: VerifyingKey, proof: Proof, publics: list[int]) -> bool:
    """Native-path Groth16 verification (same semantics as containers.verify)."""
    res = _get_lib().groth16_verify(
        vk_bytes(vk), len(vk.ic), proof_bytes(proof), publics_bytes(publics), len(publics)
    )
    if res < 0:
        raise ValueError("native verifier rejected the input layout")
    return bool(res)
