"""snarkjs `.zkey` container read/write.

The port of ``zkemail_tpu/prover/zkey.py``: for the same key and circuit
``write_zkey`` gives the JAX function's bytes, and ``read_zkey`` gives its
points, coefficients and constraint count. The reference proves under
snarkjs-generated zkeys (packages/helpers/src/chunked-zkey.ts:76-91 feeds
them to snarkjs.groth16.fullProve; the layout is snarkjs' src/zkey_utils.js
"bin file" format).

Layout (bin file): magic b"zkey", u32 version=1, u32 nSections, then
sections of (u32 type, u64 size, payload):
  1 prover type (u32 1 = groth16)
  2 groth16 header: n8q, q, n8r, r, nVars, nPublic, domainSize,
    alpha_g1, beta_g1, beta_g2, gamma_g2, delta_g1, delta_g2
  3 IC           (nPublic+1 G1)
  4 A/B coeffs   (u32 nCoeffs; each u32 matrix(0=A,1=B), u32 row, u32 col,
                  n8r-byte Montgomery value) — C is never stored
  5 pointsA      (nVars G1)       6 pointsB1 (nVars G1)
  7 pointsB2     (nVars G2)       8 pointsC  (nVars-nPublic-1 G1)
  9 pointsH      (domainSize G1)  10 contributions (ignored on read)

Field elements are little-endian Montgomery form with R = 2^256. G1 points
are (x, y) affine pairs, G2 points ((x0, x1), (y0, y1)); the zero point is
all-zero coordinates. pointsH are in the CircomReduction basis (all m
points), which this package's setup and prover use natively.

Coefficient section: written as the pure R1CS followed by the materialized
virtual instance rows (A row nC+s, col s, value 1), as snarkjs' builder
does; on read, such trailing instance rows are detected and folded out of
the inferred n_constraints.

Where the JAX package goes through Python ints point by point, the port
converts whole query tables in tensor code on the key's device: the affine
form by ``core/curve_torch.py::ec_to_affine`` (a Fermat inversion, K1 on a
CUDA tensor), then one K1 product per coordinate with a constant between
the port's R = 2^264 and the file's 2^256 (xR * (2^256 mod q) / R =
x 2^256; back, v * (2^272 mod q) / R = x R), and the repacking between 22
twelve-bit limbs and 32 little-endian bytes on whole tensors; section 4's
records through a numpy structured dtype.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..core import curve_torch as CT
from ..core import field as F
from ..core import limbs as LB
from ..core.curve import G1, G2
from ..core.towers import Fq2
from ..device import resolve_device
from .containers import VerifyingKey
from .setup import ProvingKey, matrix_pack

Q = F.FQ.p
R_SCALAR = F.R
MONT = 1 << 256
MONT_INV_Q = pow(MONT, Q - 2, Q)

GROTH16 = 1
L = F.LIMBS
FE_BYTES = 32
# one section-4 record: matrix, row, column, then an Fr value
COEFF_RECORD = np.dtype([("m", "<u4"), ("r", "<u4"), ("c", "<u4"), ("v", "u1", (FE_BYTES,))])


def _fq_bytes(v: int) -> bytes:
    return (v * MONT % Q).to_bytes(32, "little")


def _fq_read(b: bytes) -> int:
    return int.from_bytes(b, "little") * MONT_INV_Q % Q


def _fr_bytes(v: int) -> bytes:
    return (v * MONT % R_SCALAR).to_bytes(32, "little")


def _g1_bytes(p: G1) -> bytes:
    if p.inf:
        return bytes(64)
    return _fq_bytes(p.x) + _fq_bytes(p.y)


def _g1_read(b: bytes) -> G1:
    x, y = _fq_read(b[:32]), _fq_read(b[32:64])
    if x == 0 and y == 0:
        return G1.identity()
    return G1(x, y)


def _g2_bytes(p: G2) -> bytes:
    if p.inf:
        return bytes(128)
    return (
        _fq_bytes(p.x.c0) + _fq_bytes(p.x.c1) + _fq_bytes(p.y.c0) + _fq_bytes(p.y.c1)
    )


def _g2_read(b: bytes) -> G2:
    c = [_fq_read(b[i * 32 : (i + 1) * 32]) for i in range(4)]
    if all(v == 0 for v in c):
        return G2.identity()
    return G2(Fq2(c[0], c[1]), Fq2(c[2], c[3]))


# ---------------------------------------------------------------------------
# whole-table conversions (tensor code on the key's device)
# ---------------------------------------------------------------------------

def _const(fs: LB.FieldSpec, value: int, device) -> torch.Tensor:
    """(L, 1) limbs of value mod p, as a K1 multiplicand."""
    return torch.tensor(F.to_limbs(value % fs.p), dtype=torch.int32, device=device)[:, None]


def _scaled(fs: LB.FieldSpec, t: torch.Tensor, power: int) -> torch.Tensor:
    """t * 2^power * 2^-264 mod p: one K1 product with a constant."""
    return LB.mont_mul(fs, t, _const(fs, 1 << power, t.device))


def _bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(n, 32) uint8 little endian -> (L, n) int32 12-bit limbs."""
    b = torch.nn.functional.pad(b.to(torch.int32), (0, 3 * L // 2 - FE_BYTES))
    b = b.reshape(b.shape[0], L // 2, 3)
    pairs = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)).T  # (11, n)
    out = torch.empty((L, pairs.shape[1]), dtype=torch.int32, device=b.device)
    out[0::2] = pairs & F.LIMB_MASK
    out[1::2] = pairs >> F.LIMB_BITS
    return out


def _coords(v) -> list:
    return list(v) if isinstance(v, tuple) else [v]


def _query_to_bytes(q: dict, kind: str) -> bytes:
    """A projective query table -> its file section: per point the affine
    coordinates x (then y; c0 before c1 for G2) as 32-byte values x 2^256
    mod q, the point at infinity as zeros. The counterpart of the JAX
    package's ``_query_to_host_points`` + ``_g1_bytes``/``_g2_bytes``."""
    ops = CT.FQ_OPS if kind == "g1" else CT.FQ2_OPS
    aff = CT.ec_to_affine(ops, q)
    keep = ~aff["inf"]
    cols = [LB.limbs_to_bytes(_scaled(LB.FQ_SPEC, c, 256) * keep)
            for k in ("x", "y") for c in _coords(aff[k])]
    return torch.cat(cols, dim=1).cpu().numpy().tobytes()


def _query_from_bytes(raw, n: int, kind: str, device) -> dict:
    """A file section of n points -> the projective query table on
    `device`, in the JAX package's layout: affine points with z = 1, the
    all-zero point as the identity (0, 1, 0)."""
    n_coords = 2 if kind == "g1" else 4
    b = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8, count=n * n_coords * FE_BYTES)
                         .reshape(n, n_coords * FE_BYTES).copy()).to(device)
    cs = [_scaled(LB.FQ_SPEC, _bytes_to_limbs(b[:, i * FE_BYTES : (i + 1) * FE_BYTES]), 272)
          for i in range(n_coords)]
    inf = torch.stack([LB.is_zero(c) for c in cs]).all(dim=0)
    one = LB.constant(LB.FQ_SPEC, 1, (n,), device)
    zero = LB.zeros((n,), device)
    y0 = LB.select(inf, one, cs[n_coords // 2])
    z0 = LB.select(inf, zero, one)
    if kind == "g1":
        return {"x": cs[0], "y": y0, "z": z0.contiguous()}
    return {"x": (cs[0], cs[1]), "y": (y0, cs[3]), "z": (z0.contiguous(), zero.contiguous())}


def _section(stype: int, payload: bytes) -> bytes:
    return struct.pack("<IQ", stype, len(payload)) + payload


def _coeff_section(pk: ProvingKey, cc) -> bytes:
    """Section 4: the A then B entries of `cc`, then the n_public + 1
    materialized instance rows, as structured records."""
    if cc is None:
        return struct.pack("<I", 0)
    parts = []
    for mat_id, which in ((0, "A"), (1, "B")):
        rows, cols, coeff = matrix_pack(cc, which, pk.device)  # coeff: v R
        rec = np.empty(rows.shape[0], dtype=COEFF_RECORD)
        rec["m"] = mat_id
        rec["r"] = rows.cpu().numpy()
        rec["c"] = cols.cpu().numpy()
        rec["v"] = LB.limbs_to_bytes(_scaled(LB.FR_SPEC, coeff, 256)).cpu().numpy()
        parts.append(rec)
    n_inst = pk.n_public + 1
    inst = np.empty(n_inst, dtype=COEFF_RECORD)
    inst["m"] = 0
    inst["r"] = cc.n_constraints + np.arange(n_inst)
    inst["c"] = np.arange(n_inst)
    inst["v"] = np.frombuffer(_fr_bytes(1), dtype=np.uint8)
    parts.append(inst)
    records = np.concatenate(parts)
    return struct.pack("<I", len(records)) + records.tobytes()


def write_zkey(pk: ProvingKey, cc=None) -> bytes:
    """Serialize a ProvingKey (+ optional circuit's A/B coeffs) as .zkey
    bytes; the tables are converted on the key's device."""
    with torch.inference_mode():
        n_vars = pk.a_query["x"].shape[1]
        m = 1 << pk.domain_log2
        head = struct.pack("<I", 32) + Q.to_bytes(32, "little")
        head += struct.pack("<I", 32) + R_SCALAR.to_bytes(32, "little")
        head += struct.pack("<III", n_vars, pk.n_public, m)
        head += _g1_bytes(pk.alpha_g1) + _g1_bytes(pk.beta_g1) + _g2_bytes(pk.beta_g2)
        head += _g2_bytes(pk.vk.gamma_g2) + _g1_bytes(pk.delta_g1) + _g2_bytes(pk.delta_g2)
        sections = [
            _section(1, struct.pack("<I", GROTH16)),
            _section(2, head),
            _section(3, b"".join(_g1_bytes(p) for p in pk.vk.ic)),
            _section(4, _coeff_section(pk, cc)),
            _section(5, _query_to_bytes(pk.a_query, "g1")),
            _section(6, _query_to_bytes(pk.b1_query, "g1")),
            _section(7, _query_to_bytes(pk.b2_query, "g2")),
            _section(8, _query_to_bytes(pk.c_query, "g1")),
            _section(9, _query_to_bytes(pk.h_query, "g1")),
        ]
    return b"zkey" + struct.pack("<II", 1, len(sections)) + b"".join(sections)


def _read_coeffs(sec, device) -> dict:
    """Section 4 -> {"A": (rows, cols, vals), "B": ...}: rows and cols
    int64 arrays, vals an object array of standard-form Python ints."""
    n_coeffs = struct.unpack_from("<I", sec, 0)[0]
    rec = np.frombuffer(sec, dtype=COEFF_RECORD, count=n_coeffs, offset=4)
    vals = np.empty(0, dtype=object)
    if n_coeffs:
        u = torch.from_numpy(np.ascontiguousarray(rec["v"])).to(device)
        # v 2^256 * 2^8 * 2^-264 = v
        vals = LB.limbs_to_ints(_scaled(LB.FR_SPEC, _bytes_to_limbs(u), 8))
    out = {}
    for name, sel in (("A", rec["m"] == 0), ("B", rec["m"] != 0)):
        out[name] = (rec["r"][sel].astype(np.int64), rec["c"][sel].astype(np.int64),
                     vals[sel])
    return out


def _n_constraints(coeffs: dict, n_public: int) -> int:
    """The R1CS constraint count: max row + 1, less a trailing block of
    materialized instance rows (A row cand + s, col s, value 1 for every
    public s, B empty there)."""
    ra, ca, va = coeffs["A"]
    rb = coeffs["B"][0]
    all_rows = np.concatenate([ra, rb])
    n = int(all_rows.max()) + 1 if all_rows.size else 0
    cand = n - (n_public + 1)
    if cand < 0:
        return n
    in_block = (ra >= cand) & (ra <= cand + n_public)
    sel = in_block & (ca == ra - cand)
    sel[sel] = np.array([v == 1 for v in va[sel]], dtype=bool)
    covered = np.unique(ra[sel] - cand)
    b_free = not ((rb >= cand) & (rb <= cand + n_public)).any()
    return cand if len(covered) == n_public + 1 and b_free else n


def read_zkey(data, device=None) -> tuple[ProvingKey, dict]:
    """Parse .zkey bytes -> (ProvingKey with its query tables on `device`
    (default: CUDA) and an empty cache, coeffs).

    coeffs: {"A": (rows, cols, vals), "B": ...} from section 4 (vals Python
    ints) for cross-checking against the local circuit's R1CS."""
    dev = resolve_device(device)
    data = memoryview(data)
    if bytes(data[:4]) != b"zkey":
        raise ValueError("not a zkey file (bad magic)")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections = {}
    for _ in range(n_sections):
        stype, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[stype] = data[off : off + size]
        off += size

    prover_type = struct.unpack_from("<I", sections[1], 0)[0]
    if prover_type != GROTH16:
        raise ValueError(f"unsupported zkey prover type {prover_type}")

    h = bytes(sections[2])
    o = 0
    n8q = struct.unpack_from("<I", h, o)[0]; o += 4
    q = int.from_bytes(h[o : o + n8q], "little"); o += n8q
    n8r = struct.unpack_from("<I", h, o)[0]; o += 4
    r = int.from_bytes(h[o : o + n8r], "little"); o += n8r
    if q != Q or r != R_SCALAR or n8q != 32 or n8r != 32:
        raise ValueError("zkey is not over BN254")
    n_vars, n_public, m = struct.unpack_from("<III", h, o); o += 12
    alpha_g1 = _g1_read(h[o : o + 64]); o += 64
    beta_g1 = _g1_read(h[o : o + 64]); o += 64
    beta_g2 = _g2_read(h[o : o + 128]); o += 128
    gamma_g2 = _g2_read(h[o : o + 128]); o += 128
    delta_g1 = _g1_read(h[o : o + 64]); o += 64
    delta_g2 = _g2_read(h[o : o + 128]); o += 128

    ic_raw = bytes(sections[3])
    ic = [_g1_read(ic_raw[i * 64 : (i + 1) * 64]) for i in range(n_public + 1)]
    with torch.inference_mode():
        coeffs = _read_coeffs(sections[4], dev)
        tables = {
            "a_query": _query_from_bytes(sections[5], n_vars, "g1", dev),
            "b1_query": _query_from_bytes(sections[6], n_vars, "g1", dev),
            "b2_query": _query_from_bytes(sections[7], n_vars, "g2", dev),
            "c_query": _query_from_bytes(sections[8], n_vars - n_public - 1, "g1", dev),
            "h_query": _query_from_bytes(sections[9], m, "g1", dev),
        }
    vk = VerifyingKey(
        alpha_g1=alpha_g1, beta_g2=beta_g2, gamma_g2=gamma_g2,
        delta_g2=delta_g2, ic=ic,
    )
    pk = ProvingKey(
        domain_log2=(m - 1).bit_length(),
        n_public=n_public,
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        vk=vk,
        n_constraints=_n_constraints(coeffs, n_public),
        device=dev,
        **tables,
    )
    return pk, coeffs


def write_zkey_file(pk: ProvingKey, path: str, cc=None) -> None:
    with open(path, "wb") as f:
        f.write(write_zkey(pk, cc))


def read_zkey_file(path: str, device=None) -> tuple[ProvingKey, dict]:
    with open(path, "rb") as f:
        return read_zkey(f.read(), device=device)
