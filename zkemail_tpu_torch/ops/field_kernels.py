"""The port's three field/curve kernels: wrappers, plain versions, counts.

Each wrapper takes flat (22, n) int32 limb tensors (12-bit limbs, the JAX
package's layout) and dispatches on the tensors' device alone:

* a CUDA tensor launches the hand-written kernel of ``ops/csrc`` on the
  current stream of the tensors' device (K1 ``mont_mul.cu``, K2
  ``ec_add_g1.cu``, K3 ``ec_add_g2.cu``), counts the launch in
  ``LAUNCHES`` and raises if the launch is refused;
* a CPU tensor runs the plain PyTorch version in this module.

There is no fallback between the two. The kernels replace the Pallas
kernels of ``zkemail_tpu/ops/pallas_field.py`` (``_make_kernel``,
``_make_ec_add_kernel``, ``_make_ec_add_g2_kernel``); the plain versions
repeat those kernels' limb arithmetic (``_cios_body``, ``_ec_add_math``,
``_ec_add_g2_math``) on tensors, and serve both as the CPU path and as the
reference the kernels are held to on the card.

K4, the Fr NTT (``ntt_fr.cu``), is launched by ``ops/ntt.py`` through
``_launch`` and counted in ``LAUNCHES["ntt"]``; its plain version is
``ntt.ntt_plain``.

The plain additions resolve their carries with a running max over the limb
axis instead of the Pallas kernels' ripple: the integers, and hence the
canonical output limbs, are the same, and a field addition costs about 20
tensor operations instead of about 150.
"""

from __future__ import annotations

import functools

import torch

from ..core import field as F
from . import kernel_build

L = F.LIMBS
W = F.LIMB_BITS
MASK = F.LIMB_MASK

FIELD_IDS = {"Fq": 0, "Fr": 1}
_PRIMES = {"Fq": F.FQ, "Fr": F.FR}

# Kernel launches since the last reset_launches(): each wrapper adds one
# where it launches its kernel, and nowhere else ("ntt": K4's passes,
# launched by ops/ntt.py through _launch).
LAUNCHES = {"mont_mul": 0, "ec_add_g1": 0, "ec_add_g2": 0, "ntt": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _p_col(field: str, device: str, ndim: int) -> torch.Tensor:
    """The modulus limbs as an (L, 1, ...) column with `ndim` dims."""
    limbs = F.to_limbs(_PRIMES[field].p)
    return torch.tensor(limbs, dtype=torch.int32, device=device).reshape(
        (L,) + (1,) * (ndim - 1)
    )


@functools.lru_cache(maxsize=None)
def _g2_b3_limbs() -> tuple:
    """b3 = 3 b' = 9/(9+u) of the G2 twist as Montgomery Fq limbs (c0, c1)."""
    from ..core.towers import XI

    b3 = XI.inv() * 9
    return tuple(
        tuple(F.to_limbs(F.FQ.to_mont(int(c)))) for c in (b3.c0, b3.c1)
    )


# ---------------------------------------------------------------------------
# plain limb arithmetic (any shape (L, ...), any device)
# ---------------------------------------------------------------------------

def _prefix_carry(gen: torch.Tensor, prop: torch.Tensor):
    """Carries into each limb, from per-limb generate/propagate bits.

    carry_in[0] = 0 and carry_in[i+1] = gen[i] | (prop[i] & carry_in[i]).
    The carry out of limb i is gen at the last limb j <= i that does not
    propagate (none: 0), found with a running max over axis 0. Returns
    (carry_in as int32, carry out of the top limb as bool)."""
    k = gen.shape[0]
    pos = torch.arange(k, device=gen.device).reshape((k,) + (1,) * (gen.dim() - 1))
    last = torch.cummax(torch.where(prop, -1, pos), dim=0).values
    gen0 = torch.cat([torch.zeros_like(gen[:1]), gen])  # row 0: "no such limb"
    out = torch.gather(gen0, 0, last + 1)
    carry_in = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
    return carry_in.to(torch.int32), out[-1]


def _add_norm(a: torch.Tensor, b: torch.Tensor):
    """a + b on normalized limbs -> (normalized limbs, carry out)."""
    t = a + b
    lo = t & MASK
    carry, out = _prefix_carry((t >> W) != 0, lo == MASK)
    return (lo + carry) & MASK, out


def _sub_norm(a: torch.Tensor, b: torch.Tensor):
    """a - b on normalized limbs -> (normalized limbs mod 2^(W*L), borrow)."""
    d = a - b
    borrow, out = _prefix_carry(d < 0, d == 0)
    return (d - borrow) & MASK, out


def normalize(t: torch.Tensor) -> torch.Tensor:
    """Nonnegative int32 limbs below 2^31 -> 12-bit limbs of the same value
    (mod 2^(W * t.shape[0])): three rounds of shifting each limb's high
    bits up bring every carry to 0 or 1, and a prefix scan resolves those."""
    for _ in range(3):
        hi = t >> W
        t = (t & MASK) + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])
    lo = t & MASK
    carry, _ = _prefix_carry((t >> W) != 0, lo == MASK)
    return (lo + carry) & MASK


def cond_sub_p(field: str, t: torch.Tensor) -> torch.Tensor:
    """t mod p for normalized limbs of a value below 2p."""
    s, borrow = _sub_norm(t, _p_col(field, str(t.device), t.dim()))
    return torch.where(borrow.unsqueeze(0), t, s)


def addm(field: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y mod p, canonical in and out (pallas_field._addm)."""
    return cond_sub_p(field, _add_norm(x, y)[0])


def subm(field: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y mod p, canonical in and out (pallas_field._subm): x - y, plus
    p where it borrowed (mod 2^264 the sum is x - y + p, in (0, p))."""
    d, borrow = _sub_norm(x, y)
    dp = _add_norm(d, _p_col(field, str(x.device), x.dim()))[0]
    return torch.where(borrow.unsqueeze(0), dp, d)


def mont_mul_plain(field: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: CIOS Montgomery product a * b * 2^-264 mod p on
    (L, n) canonical limbs, the 22 iterations of pallas_field._cios_body.

    The accumulator keeps absolute limb positions (row i + j holds the
    Pallas kernel's t[j] of iteration i), which replaces its shift by an
    offset; each row stays below 2^31 as in the kernel."""
    n0inv = _PRIMES[field].n0inv
    p = _p_col(field, str(a.device), 2)
    t = torch.zeros((2 * L + 1,) + tuple(a.shape[1:]), dtype=torch.int32,
                    device=a.device)
    for i in range(L):
        acc = t[i : i + L]
        acc.addcmul_(a[i], b)
        m = ((t[i] & MASK) * n0inv) & MASK
        acc.addcmul_(m, p)
        t[i + 1] += t[i] >> W  # the low W bits of t[i] are zero here
    return cond_sub_p(field, normalize(t[L:])[:L])


def _mul_many(pairs: list) -> list:
    """Independent Fq products of same-shape (L, n) pairs as ONE plain CIOS
    over the stacked lanes (the Pallas kernels' _mul6_fori waves)."""
    n = pairs[0][0].shape[1]
    a = torch.cat([x for x, _ in pairs], dim=1)
    b = torch.cat([y for _, y in pairs], dim=1)
    out = mont_mul_plain("Fq", a, b)
    return [out[:, k * n : (k + 1) * n] for k in range(len(pairs))]


def ec_add_g1_plain(p: dict, q: dict, neg: torch.Tensor) -> dict:
    """Plain version of K2 (pallas_field._ec_add_math): RCB Algorithm 7 on
    G1, a = 0 and b3 = 9, adding -q on lanes where neg != 0."""
    def add(x, y):
        return addm("Fq", x, y)

    def sub(x, y):
        return subm("Fq", x, y)

    def mul_b3(x):  # 9x = 8x + x
        x2 = add(x, x)
        x4 = add(x2, x2)
        return add(add(x4, x4), x)

    x1, y1, z1 = p["x"], p["y"], p["z"]
    x2, y2, z2 = q["x"], q["y"], q["z"]
    y2 = torch.where(neg.unsqueeze(0) != 0, sub(torch.zeros_like(y2), y2), y2)
    t0, t1, t2, m3, m4, m5 = _mul_many([
        (x1, x2), (y1, y2), (z1, z2),
        (add(x1, y1), add(x2, y2)),
        (add(y1, z1), add(y2, z2)),
        (add(x1, z1), add(x2, z2)),
    ])
    t3 = sub(sub(m3, t0), t1)
    t4 = sub(sub(m4, t1), t2)
    f5 = sub(sub(m5, t0), t2)
    t0_3 = add(add(t0, t0), t0)
    t2_b3 = mul_b3(t2)
    y3_b3 = mul_b3(f5)
    z3a = add(t1, t2_b3)
    t1m = sub(t1, t2_b3)
    a1, a2, a3, a4, a5, a6 = _mul_many([
        (t4, y3_b3), (t3, t1m), (y3_b3, t0_3),
        (t1m, z3a), (t0_3, t3), (z3a, t4),
    ])
    return {"x": sub(a2, a1), "y": add(a4, a3), "z": add(a6, a5)}


def _fq2_mul_many(pairs2: list) -> list:
    """Karatsuba Fq2 products, all 3K Fq products in one plain CIOS
    (pallas_field._fq2_mul_wave)."""
    fq = []
    for (a0, a1), (b0, b1) in pairs2:
        fq += [(a0, b0), (a1, b1), (addm("Fq", a0, a1), addm("Fq", b0, b1))]
    res = _mul_many(fq)
    out = []
    for k in range(len(pairs2)):
        t0, t1, s = res[3 * k : 3 * k + 3]
        out.append((subm("Fq", t0, t1), subm("Fq", subm("Fq", s, t0), t1)))
    return out


def ec_add_g2_plain(p: dict, q: dict, neg: torch.Tensor) -> dict:
    """Plain version of K3 (pallas_field._ec_add_g2_math): RCB Algorithm 7
    on G2 over Fq2, b3 = 9/(9+u), adding -q on lanes where neg != 0."""
    def add(x, y):
        return (addm("Fq", x[0], y[0]), addm("Fq", x[1], y[1]))

    def sub(x, y):
        return (subm("Fq", x[0], y[0]), subm("Fq", x[1], y[1]))

    x1, y1, z1 = p["x"], p["y"], p["z"]
    x2, y2, z2 = q["x"], q["y"], q["z"]
    negm = neg.unsqueeze(0) != 0
    zero = torch.zeros_like(y2[0])
    y2 = tuple(torch.where(negm, subm("Fq", zero, c), c) for c in y2)
    t0, t1, t2, m3, m4, m5 = _fq2_mul_many([
        (x1, x2), (y1, y2), (z1, z2),
        (add(x1, y1), add(x2, y2)),
        (add(y1, z1), add(y2, z2)),
        (add(x1, z1), add(x2, z2)),
    ])
    t3 = sub(sub(m3, t0), t1)
    t4 = sub(sub(m4, t1), t2)
    f5 = sub(sub(m5, t0), t2)
    t0_3 = add(add(t0, t0), t0)
    k0, k1 = _g2_b3_limbs()
    shape = (L, zero.shape[1])
    b3 = tuple(
        torch.tensor(k, dtype=torch.int32, device=zero.device)[:, None].expand(shape)
        for k in (k0, k1)
    )
    t2_b3, y3_b3 = _fq2_mul_many([(t2, b3), (f5, b3)])
    z3a = add(t1, t2_b3)
    t1m = sub(t1, t2_b3)
    a1, a2, a3, a4, a5, a6 = _fq2_mul_many([
        (t4, y3_b3), (t3, t1m), (y3_b3, t0_3),
        (t1m, z3a), (t0_3, t3), (z3a, t4),
    ])
    return {"x": sub(a2, a1), "y": add(a4, a3), "z": add(a6, a5)}


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_flat(tensors: list, what: str) -> int:
    """Every tensor (L, n) int32 contiguous on one device; returns n."""
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != L:
            raise ValueError(f"{what}: expected ({L}, n) int32 limbs, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{what}: operands differ in shape or device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {first.device}")
    return first.shape[1]


def _check_neg(neg: torch.Tensor, n: int, device) -> None:
    if neg.dtype != torch.int32 or tuple(neg.shape) != (n,) or neg.device != device:
        raise ValueError(f"neg must be ({n},) int32 on {device}, got "
                         f"{tuple(neg.shape)} {neg.dtype} on {neg.device}")
    if not neg.is_contiguous():
        raise ValueError("neg must be contiguous")


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Launch on the operands' device: the C launchers use the calling
    thread's current device, which need not be the operands'."""
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def mont_mul_flat(field: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-264 mod p over `field` ("Fq" or "Fr") on (L, n) limbs."""
    n = _check_flat([a, b], "mont_mul")
    if a.device.type == "cpu":
        return mont_mul_plain(field, a, b)
    out = torch.empty_like(a)
    if n:
        lib = kernel_build.library()
        _launch("mont_mul", a.device, lib.zk_mont_mul, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), n, FIELD_IDS[field], _stream(a))
    return out


def ec_add_g1_flat(p: dict, q: dict, neg: torch.Tensor) -> dict:
    """Complete G1 addition p + (neg != 0 ? -q : q) of flat coordinate dicts
    {"x","y","z"} of (L, n) Montgomery limbs; neg is (n,) int32."""
    coords = [p[k] for k in "xyz"] + [q[k] for k in "xyz"]
    n = _check_flat(coords, "ec_add_g1")
    _check_neg(neg, n, coords[0].device)
    if coords[0].device.type == "cpu":
        return ec_add_g1_plain(p, q, neg)
    out = {k: torch.empty_like(p[k]) for k in "xyz"}
    if n:
        lib = kernel_build.library()
        _launch("ec_add_g1", neg.device, lib.zk_ec_add_g1,
                *[c.data_ptr() for c in coords], neg.data_ptr(),
                *[out[k].data_ptr() for k in "xyz"], n, _stream(neg))
    return out


def ec_add_g2_flat(p: dict, q: dict, neg: torch.Tensor) -> dict:
    """Complete G2 addition of flat Fq2 coordinate dicts {"x","y","z"} of
    (c0, c1) pairs of (L, n) Montgomery limbs; neg as in ec_add_g1_flat."""
    coords = [p[k][c] for k in "xyz" for c in (0, 1)]
    coords += [q[k][c] for k in "xyz" for c in (0, 1)]
    n = _check_flat(coords, "ec_add_g2")
    _check_neg(neg, n, coords[0].device)
    if coords[0].device.type == "cpu":
        return ec_add_g2_plain(p, q, neg)
    out = {k: (torch.empty_like(p[k][0]), torch.empty_like(p[k][1])) for k in "xyz"}
    if n:
        lib = kernel_build.library()
        _launch("ec_add_g2", neg.device, lib.zk_ec_add_g2,
                *[c.data_ptr() for c in coords], neg.data_ptr(),
                *[out[k][c].data_ptr() for k in "xyz" for c in (0, 1)],
                n, _stream(neg))
    return out
