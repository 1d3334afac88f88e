"""Pippenger multi-scalar multiplication on PyTorch tensors.

The port of the bucket MSM of ``zkemail_tpu/ops/msm.py`` (``msm_multi``, the
path the JAX package proves with on the CPU), with the same algorithm:

  * signed 8-bit windows (32 windows, 128 buckets each), digits extracted
    from the 12-bit limbs;
  * bucket accumulation over point chunks: T "threads" each own a private
    (windows x buckets) table, and every step does ONE batched complete
    addition across (windows * T) lanes — K2 (G1) or K3 (G2) on the card,
    with the digit's sign folded into the kernel;
  * tree reduction over threads, running-sum bucket reduction, Horner
    combination of the windows (its doublings as complete additions).

The bucket table of a batched MSM holds B * 32 * 128 * T points (264 bytes
each on G1, 528 on G2) and is updated in place with gather/scatter.

Also the fixed-base batched multiplication of the CRS setup
(``fixed_base_batch``): 32 complete additions of table points per lane.
"""

from __future__ import annotations

import functools

import torch

from ..core import curve_torch as CT
from ..core import field as F
from ..core import limbs as LB

L = F.LIMBS
C_BITS = 8
N_WINDOWS = 32

# Thread counts on the card: one bucket-accumulation step then spans
# B * 32 * T lanes, 2^18 for G1 and 2^16 for G2 at B = 2, enough to fill the
# H100's 132 SMs; the B = 2 tables take 8.9 GB (G1) and 4.4 GB (G2).
CUDA_THREADS = {"fq": 4096, "fq2": 1024}


def extract_signed_digits(
    scalars: torch.Tensor, c_bits: int = C_BITS, n_windows: int = N_WINDOWS
) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, n) standard-form Fr scalars -> signed digit magnitudes and signs.

    Returns (mag, neg): uint8 (n_windows, n) with mag in 0..2^(c-1) and neg
    in {0, 1}. The digit is (1 - 2 neg) * mag; mag == 0 means skip."""
    half = 1 << (c_bits - 1)
    full = 1 << c_bits
    digits = []
    for w in range(n_windows):
        off = w * c_bits
        limb, sh = divmod(off, F.LIMB_BITS)
        val = scalars[limb] >> sh
        got = F.LIMB_BITS - sh
        while got < c_bits and limb + (got + F.LIMB_BITS - 1) // F.LIMB_BITS < L:
            nxt = limb + 1 + (got - (F.LIMB_BITS - sh)) // F.LIMB_BITS
            val = val | (scalars[nxt] << got)
            got += F.LIMB_BITS
        digits.append(val & (full - 1))
    carry = torch.zeros_like(digits[0])
    signed = []
    for dw in digits:
        dw = dw + carry
        carry = (dw > half).to(dw.dtype)
        signed.append(dw - full * carry)
    signed = torch.stack(signed, dim=0)
    mag_dtype = torch.uint8 if c_bits <= 8 else torch.int16
    return signed.abs().to(mag_dtype), (signed < 0).to(torch.uint8)


# ---------------------------------------------------------------------------
# point dict utilities (coords are (L, ...) tensors or (c0, c1) tuples)
# ---------------------------------------------------------------------------

def map_coords(pt: dict, f) -> dict:
    return {
        k: tuple(f(c) for c in v) if isinstance(v, tuple) else f(v)
        for k, v in pt.items()
    }


def concat_points(pts: list, dim: int) -> dict:
    """Concatenate point dicts along batch axis `dim` (limb axis excluded)."""
    out = {}
    for k, v in pts[0].items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.cat([p[k][i] for p in pts], dim=dim + 1)
                           for i in range(len(v)))
        else:
            out[k] = torch.cat([p[k] for p in pts], dim=dim + 1)
    return out


def _first(pt: dict) -> torch.Tensor:
    x = pt["x"]
    return x[0] if isinstance(x, tuple) else x


def default_threads(ops, n: int, device) -> int:
    """T for a batched MSM: CUDA_THREADS on the card. On the CPU one: the
    plain versions cost in proportion to their lanes, and T = 1 keeps the
    table at B * 32 * 128 points with no tree reduction."""
    if torch.device(device).type == "cuda":
        return max(1, min(CUDA_THREADS[ops.name], n // 4 or 1))
    return 1


def msm(ops, points: dict, scalars: torch.Tensor):
    """sum_i scalars[i] * points[i] for (L, n) standard-form Fr scalars;
    returns one projective point (batch shape ())."""
    out = msm_multi(ops, points, scalars.unsqueeze(1))
    return map_coords(out, lambda c: c[:, 0])


def msm_multi(ops, points: dict, scalars: torch.Tensor, c_bits: int = C_BITS,
              threads: int = 0):
    """Batched MSM with shared bases: scalars (L, B, n) -> point batch (B,).

    The batch rides the window axis: one bucket accumulation serves all B
    scalar vectors over the same points, with (B * W, T) lanes per step.
    c_bits: the signed window width; threads: T (0: default_threads)."""
    if scalars.dim() != 3 or scalars.shape[0] != L:
        raise ValueError(
            f"msm_multi expects scalars shaped (L={L}, B, n); got {tuple(scalars.shape)}"
        )
    _, bsz, n = scalars.shape
    n_points = _first(points).shape[1]
    if n != n_points:
        raise ValueError(
            f"msm_multi: scalars last axis ({n}) must equal point count "
            f"({n_points}); batch axis goes second"
        )
    n_windows = -(-254 // c_bits)
    t_threads = threads or default_threads(ops, n, scalars.device)
    mag, neg = extract_signed_digits(scalars.reshape(L, bsz * n), c_bits, n_windows)
    # (W, B*n) -> (B*W, n): each batch element owns a contiguous window block
    mag = mag.reshape(n_windows, bsz, n).transpose(0, 1).reshape(bsz * n_windows, n)
    neg = neg.reshape(n_windows, bsz, n).transpose(0, 1).reshape(bsz * n_windows, n)
    total = _window_sums(ops, points, mag, neg, t_threads, 1 << (c_bits - 1))
    total = map_coords(total, lambda c: c.reshape(L, bsz, n_windows))
    return _horner_combine(ops, total, n_windows, c_bits)


def _window_sums(ops, points, mag, neg, t_threads: int, n_buckets: int):
    """Bucket accumulation + thread tree-reduce + running-sum reduction.

    mag/neg: (Weff, n) signed digits over a shared point batch (n,).
    Returns per-window sums: a point with batch shape (Weff,)."""
    n_windows, n = mag.shape
    n_pad = -(-n // t_threads) * t_threads
    if n_pad != n:
        mag = torch.nn.functional.pad(mag, (0, n_pad - n))
        neg = torch.nn.functional.pad(neg, (0, n_pad - n))
    device = mag.device
    buckets = CT.ec_identity(ops, (n_windows, n_buckets, t_threads), device)
    buckets = map_coords(buckets, lambda c: c.contiguous())
    _bucket_accum(ops, buckets, points, mag, neg, t_threads)
    return _window_tail(ops, buckets, t_threads)


def _bucket_accum(ops, buckets, points, mag, neg, t_threads: int) -> None:
    """Add every point into its digit's bucket, in place: the Pippenger hot
    loop. buckets: batch (Weff, NB, T); points: batch (n,); mag/neg
    (Weff, n_pad) with n_pad a multiple of T (zero digits past n)."""
    n_windows, n_pad = mag.shape
    n = _first(points).shape[1]
    for s0 in range(0, n_pad, t_threads):
        s1 = s0 + t_threads
        mg = mag[:, s0:s1].to(torch.int64)  # (W, T)
        ng = neg[:, s0:s1].to(torch.int32)

        def lanes(c):  # point slice (L, T) broadcast over windows, flat
            part = c[:, s0:min(s1, n)]
            if part.shape[1] < t_threads:
                part = torch.nn.functional.pad(part, (0, t_threads - part.shape[1]))
            return part[:, None, :].expand(L, n_windows, t_threads).reshape(L, -1)

        pt = map_coords(points, lanes)
        idx = (mg - 1).clamp_min(0)[None, :, None, :].expand(L, n_windows, 1, t_threads)
        cur = map_coords(buckets, lambda c: torch.gather(c, 2, idx).reshape(L, -1))
        added = CT.ec_add_signed(ops, cur, pt, ng.reshape(-1))
        keep = (mg == 0).reshape(-1)
        new = CT.ec_select(ops, keep, cur, added)
        for k, v in buckets.items():
            if isinstance(v, tuple):
                for c, nc in zip(v, new[k]):
                    c.scatter_(2, idx, nc.reshape(L, n_windows, 1, t_threads))
            else:
                v.scatter_(2, idx, new[k].reshape(L, n_windows, 1, t_threads))


def _window_tail(ops, buckets, t_threads: int):
    """Thread tree-reduce + running-sum bucket reduction: a (Weff, NB, T)
    bucket table -> per-window sums (Weff,)."""
    tt = t_threads
    while tt > 1:
        half = tt // 2
        a = map_coords(buckets, lambda c: c[..., :half])
        b = map_coords(buckets, lambda c: c[..., half : 2 * half])
        s = CT.ec_add(ops, a, b)
        if tt % 2:
            rest = map_coords(buckets, lambda c: c[..., 2 * half : tt])
            s = concat_points([s, rest], dim=2)
            tt = half + 1
        else:
            tt = half
        buckets = s
    buckets = map_coords(buckets, lambda c: c[..., 0])  # (W, NB)

    # running-sum bucket reduction: S_w = sum_b (b + 1) * bucket[b]
    n_windows, n_buckets = ops.batch_shape(buckets["x"])
    ident = CT.ec_identity(ops, (n_windows,), _first(buckets).device)
    run, total = ident, ident
    for b in range(n_buckets - 1, -1, -1):
        run = CT.ec_add(ops, run, map_coords(buckets, lambda c: c[:, :, b]))
        total = CT.ec_add(ops, total, run)
    return total


def _horner_combine(ops, total, n_windows: int, c_bits: int):
    """res = sum_w 2^(c*w) S_w over the LAST batch axis of `total`.

    Each doubling is the complete addition res + res: one K2/K3 launch,
    where a doubling composed of field operations is a few hundred."""
    res = map_coords(total, lambda c: c[..., n_windows - 1])
    for w in range(n_windows - 2, -1, -1):
        for _ in range(c_bits):
            res = CT.ec_add(ops, res, res)
        res = CT.ec_add(ops, res, map_coords(total, lambda c: c[..., w]))
    return res


# ---------------------------------------------------------------------------
# Fixed-base batched scalar multiplication (setup / CRS generation)
# ---------------------------------------------------------------------------

def extract_digits_unsigned(scalars: torch.Tensor) -> torch.Tensor:
    """(L, n) standard Fr limbs -> (N_WINDOWS, n) unsigned 8-bit digits."""
    digits = []
    for w in range(N_WINDOWS):
        off = w * C_BITS
        limb, sh = divmod(off, F.LIMB_BITS)
        val = scalars[limb] >> sh
        if C_BITS - (F.LIMB_BITS - sh) > 0 and limb + 1 < L:
            val = val | (scalars[limb + 1] << (F.LIMB_BITS - sh))
        digits.append(val & ((1 << C_BITS) - 1))
    return torch.stack(digits, dim=0)


@functools.lru_cache(maxsize=None)
def _fb_table_host(kind: str):
    """(N_WINDOWS, 256) table of base * (d << 8w) as host points."""
    from ..core.curve import G1, G2

    base = G1.generator() if kind == "g1" else G2.generator()
    ident = G1.identity() if kind == "g1" else G2.identity()
    table = []
    step = base
    for _ in range(N_WINDOWS):
        row = [ident]
        for _ in range(1, 256):
            row.append(row[-1].add(step))
        table.append(row)
        step = row[-1].add(step)  # base * (256 << 8w) = base * (1 << 8(w+1))
    return table


def _fb_table_dev(kind: str, device) -> dict:
    """The fixed-base table as projective coordinates (L, N_WINDOWS, 256)."""
    flat = [p for row in _fb_table_host(kind) for p in row]
    if kind == "g1":
        pts = points_from_affine_ints(
            CT.FQ_OPS,
            [p.x if not p.inf else 0 for p in flat],
            [p.y if not p.inf else 1 for p in flat],
            [p.inf for p in flat],
            device,
        )
    else:
        pts = g2_points_from_affine(
            [0 if p.inf else p.x.c0 for p in flat],
            [0 if p.inf else p.x.c1 for p in flat],
            [1 if p.inf else p.y.c0 for p in flat],
            [0 if p.inf else p.y.c1 for p in flat],
            [p.inf for p in flat],
            device,
        )
    return map_coords(pts, lambda c: c.reshape(L, N_WINDOWS, 256))


def fixed_base_batch(kind: str, scalars: torch.Tensor) -> dict:
    """(L, n) standard-form Fr scalars s_i -> projective points s_i * G of
    the G1 or G2 generator, on the scalars' device: 32 batched complete
    additions of table points (one per 8-bit window) over all n lanes."""
    ops = CT.FQ_OPS if kind == "g1" else CT.FQ2_OPS
    n = scalars.shape[1]
    digits = extract_digits_unsigned(scalars).to(torch.int64)
    table = _fb_table_dev(kind, scalars.device)
    acc = CT.ec_identity(ops, (n,), scalars.device)
    for w in range(N_WINDOWS):
        sel = map_coords(table, lambda c: c[:, w, :].index_select(1, digits[w]))
        acc = CT.ec_add(ops, acc, sel)
    return acc


def points_from_affine_ints(ops, xs, ys, infs=None, device="cpu") -> dict:
    """Host affine integer coordinates -> projective G1 point dict."""
    if ops is not CT.FQ_OPS:
        raise NotImplementedError("use g2_points_from_affine for G2")
    n = len(xs)
    infs = list(infs) if infs is not None else [False] * n
    x = ops.from_ints([0 if infs[i] else xs[i] for i in range(n)], device)
    y = ops.from_ints([1 if infs[i] else ys[i] for i in range(n)], device)
    z = ops.from_ints([0 if infs[i] else 1 for i in range(n)], device)
    return {"x": x, "y": y, "z": z}


def g2_points_from_affine(xs0, xs1, ys0, ys1, infs=None, device="cpu") -> dict:
    """Host affine Fq2 coordinates -> projective G2 point dict."""
    fq = CT.FQ_OPS
    n = len(xs0)
    infs = list(infs) if infs is not None else [False] * n
    x0 = fq.from_ints([0 if infs[i] else xs0[i] for i in range(n)], device)
    x1 = fq.from_ints([0 if infs[i] else xs1[i] for i in range(n)], device)
    y0 = fq.from_ints([1 if infs[i] else ys0[i] for i in range(n)], device)
    y1 = fq.from_ints([0 if infs[i] else ys1[i] for i in range(n)], device)
    z0 = fq.from_ints([0 if infs[i] else 1 for i in range(n)], device)
    z1 = fq.from_ints([0] * n, device)
    return {"x": (x0, x1), "y": (y0, y1), "z": (z0, z1)}
