"""BN254 field arithmetic on PyTorch tensors: 22 x 12-bit limbs in int32.

The port of ``zkemail_tpu/core/limbs.py``. A field element batch is an
int32 tensor of shape ``(L, ...)``: limbs on the leading axis, the batch
behind it, the JAX package's layout, so tensors and numpy arrays cross
between the packages unchanged. Values inside the prover are in Montgomery
form with R = 2^264.

``mont_mul`` dispatches on the device of its operands only: a CUDA tensor
runs kernel K1 (``ops/csrc/mont_mul.cu``), a CPU tensor the plain PyTorch
version (``ops/field_kernels.mont_mul_plain``). Additions, subtractions and
selections are plain tensor code on either device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..ops import field_kernels as FK
from . import field as F

L = F.LIMBS
W = F.LIMB_BITS
MASK = F.LIMB_MASK


@dataclass(frozen=True)
class FieldSpec:
    """Montgomery constants for one prime field."""

    name: str
    p: int = dc_field(repr=False)
    p_limbs: tuple = dc_field(repr=False)
    n0inv: int = dc_field(repr=False)
    r_limbs: tuple = dc_field(repr=False)  # R mod p        (Montgomery one)
    r2_limbs: tuple = dc_field(repr=False)  # R^2 mod p     (to-Montgomery factor)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def make(name: str) -> "FieldSpec":
        pf = {"Fq": F.FQ, "Fr": F.FR}[name]
        return FieldSpec(
            name=name,
            p=pf.p,
            p_limbs=tuple(F.to_limbs(pf.p)),
            n0inv=pf.n0inv,
            r_limbs=tuple(F.to_limbs(pf.r_mod_p)),
            r2_limbs=tuple(F.to_limbs(pf.r2_mod_p)),
        )


FQ_SPEC = FieldSpec.make("Fq")
FR_SPEC = FieldSpec.make("Fr")


# --------------------------------------------------------------------------
# Host <-> limb conversion
# --------------------------------------------------------------------------

def ints_to_limbs(values) -> np.ndarray:
    """Python ints (nested lists ok) -> int32 limb array of shape (L, *shape).

    One int.to_bytes per value; the 12-bit limb extraction is numpy."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return np.zeros((L,) + arr.shape, dtype=np.int32)
    nbytes = (L * W + 7) // 8
    try:
        buf = b"".join(int(v).to_bytes(nbytes, "little") for v in flat)
    except OverflowError as exc:
        raise ValueError("value too large for limb representation") from exc
    u8 = np.frombuffer(buf, dtype=np.uint8).reshape(n, nbytes).astype(np.int64)
    u8 = np.pad(u8, ((0, 0), (0, 2)))  # so every limb can read 3 bytes
    out = np.empty((L, n), dtype=np.int32)
    for i in range(L):
        byte0, off = divmod(i * W, 8)
        v = u8[:, byte0] | (u8[:, byte0 + 1] << 8) | (u8[:, byte0 + 2] << 16)
        out[i] = (v >> off) & MASK
    return out.reshape((L,) + arr.shape)


def limbs_to_ints(limbs) -> np.ndarray:
    """(L, *shape) limbs (numpy or tensor) -> object ndarray of Python ints.

    Adjacent 12-bit limb pairs are exact 3-byte groups, packed with numpy,
    then one int.from_bytes per element."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    limbs = np.asarray(limbs)
    flat = limbs.reshape(L, -1).astype(np.int64)
    n = flat.shape[1]
    if n == 0:
        return np.empty(limbs.shape[1:], dtype=object)
    pairs = flat[0::2] | (flat[1::2] << W)  # (L/2, n), 24-bit values
    nb = 3 * (L // 2)
    b = np.empty((nb, n), dtype=np.uint8)
    b[0::3] = pairs & 0xFF
    b[1::3] = (pairs >> 8) & 0xFF
    b[2::3] = (pairs >> 16) & 0xFF
    buf = np.ascontiguousarray(b.T).tobytes()
    out = np.empty((n,), dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(buf[i * nb : (i + 1) * nb], "little")
    return out.reshape(limbs.shape[1:])


def limbs_to_bytes(t: torch.Tensor) -> torch.Tensor:
    """(L, n) 12-bit limbs of values below 2^256 -> (n, 32) uint8, little
    endian: limb pairs are exact 3-byte groups."""
    pairs = (t[0::2] | (t[1::2] << W)).T  # (n, 11), 24-bit
    b = torch.stack([pairs & 0xFF, (pairs >> 8) & 0xFF, pairs >> 16], dim=2)
    return b.reshape(t.shape[1], 3 * L // 2)[:, :32].to(torch.uint8)


def to_device(limbs, device) -> torch.Tensor:
    """A limb array (numpy or tensor) as an int32 tensor on `device`."""
    if isinstance(limbs, torch.Tensor):
        return limbs.to(device=device, dtype=torch.int32)
    return torch.tensor(np.asarray(limbs, dtype=np.int32), device=device)


def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((L,) + tuple(shape), dtype=torch.int32, device=device)


def constant(fs: FieldSpec, value: int, shape=(), device="cpu", mont: bool = True) -> torch.Tensor:
    """A Python-int constant broadcast to (L, *shape) (Montgomery by default)."""
    v = value % fs.p
    if mont:
        v = (v * F.MONT_R) % fs.p
    base = torch.tensor(F.to_limbs(v), dtype=torch.int32, device=device)
    return base.reshape((L,) + (1,) * len(shape)).expand((L,) + tuple(shape))


def expand_batch(a: torch.Tensor, shape) -> torch.Tensor:
    """(L, *s) limbs broadcast to (L, *shape), batch axes aligned right."""
    a = a.reshape((L,) + (1,) * (len(shape) - (a.dim() - 1)) + tuple(a.shape[1:]))
    return a.expand((L,) + tuple(shape))


def _bcast(a: torch.Tensor, b: torch.Tensor):
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    return expand_batch(a, shape), expand_batch(b, shape), shape


# --------------------------------------------------------------------------
# Field operations (canonical in, canonical out)
# --------------------------------------------------------------------------

def add(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b, _ = _bcast(a, b)
    return FK.addm(fs.name, a, b)


def sub(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b, _ = _bcast(a, b)
    return FK.subm(fs.name, a, b)


def neg(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(p - a) mod p; 0 maps to 0."""
    return sub(fs, torch.zeros_like(a), a)


def mont_mul(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p with broadcasting over the
    batch axes: K1 on a CUDA tensor, the plain CIOS on a CPU tensor."""
    a, b, shape = _bcast(a, b)
    n = 1
    for d in shape:
        n *= d
    out = FK.mont_mul_flat(
        fs.name, a.reshape(L, n).contiguous(), b.reshape(L, n).contiguous()
    )
    return out.reshape((L,) + tuple(shape))


def _col(limbs: tuple, ndim: int, device) -> torch.Tensor:
    """Constant limbs as an (L, 1, ...) column with `ndim` dims on `device`."""
    return _col_cached(limbs, ndim, str(device))


@functools.lru_cache(maxsize=None)
def _col_cached(limbs: tuple, ndim: int, device: str) -> torch.Tensor:
    return torch.tensor(limbs, dtype=torch.int32, device=device).reshape(
        (L,) + (1,) * (ndim - 1)
    )


def to_mont(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(fs, a, _col(fs.r2_limbs, a.dim(), a.device))


def from_mont(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(fs, a, _col(tuple([1] + [0] * (L - 1)), a.dim(), a.device))


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(cond, a, b) with cond shaped like the batch (no limb axis)."""
    return torch.where(cond.unsqueeze(0).bool(), a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def pow_const(fs: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a Python-int exponent, a in Montgomery form (MSB-first
    square-and-multiply, as the JAX package's ladder)."""
    acc = _col(fs.r_limbs, a.dim(), a.device).expand(a.shape).contiguous()
    for bit in bin(e)[2:] if e else "":
        acc = mont_mul(fs, acc, acc)
        if bit == "1":
            acc = mont_mul(fs, acc, a)
    return acc


def inv(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Element-wise inverse; 0 maps to 0. Montgomery in/out.

    A CUDA tensor runs Fermat's ladder (a^(p-2)) in K1. A CPU tensor takes
    Python's pow on each value, as the JAX package's host path does, in
    place of the ladder's 380-odd plain products."""
    if a.is_cuda:
        return pow_const(fs, a, fs.p - 2)
    r2 = (F.MONT_R * F.MONT_R) % fs.p  # (aR)^-1 * R^2 = a^-1 * R
    vals = limbs_to_ints(a).reshape(-1)
    out = [pow(int(v), -1, fs.p) * r2 % fs.p if int(v) % fs.p else 0 for v in vals]
    return torch.from_numpy(ints_to_limbs(out)).reshape(a.shape)


def _scan_products(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the last axis (Hillis-Steele)."""
    n = x.shape[-1]
    k = 1
    while k < n:
        x = torch.cat([x[..., :k], mont_mul(fs, x[..., k:], x[..., : n - k])], dim=-1)
        k *= 2
    return x


def batch_inv(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Inverses along the last axis of (L, n) with ONE Fermat inversion
    (Montgomery's trick); 0 maps to 0. The prefix and suffix products are
    log-depth scans instead of the JAX package's sequential scan."""
    one = _col(fs.r_limbs, a.dim(), a.device).expand(a.shape)
    zero = is_zero(a)
    safe = select(zero, one, a)
    pre = _scan_products(fs, safe)  # pre[i] = prod_{j<=i}
    suf = _scan_products(fs, safe.flip(-1)).flip(-1)  # suf[i] = prod_{j>=i}
    total_inv = inv(fs, pre[..., -1:])
    ones = one[..., :1]
    pre_ex = torch.cat([ones, pre[..., :-1]], dim=-1)
    suf_ex = torch.cat([suf[..., 1:], ones], dim=-1)
    out = mont_mul(fs, mont_mul(fs, pre_ex, suf_ex), total_inv)
    return select(zero, torch.zeros_like(out), out)
