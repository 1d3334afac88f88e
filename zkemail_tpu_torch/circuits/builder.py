"""Constraint-system builder: R1CS emission (numpy) and the witness (torch).

The port of ``zkemail_tpu/circuits/builder.py``. The build side is the JAX
package's numpy code unchanged: gadgets emit R1CS rows in bulk as COO
batches and register *witness steps*, and ``compile`` permutes the signals
(publics first) and packs the matrices. Building never touches a device.

The witness side runs every step as torch ops on one device (CUDA unless the
caller passes device="cpu"): ``CompiledCircuit.eval_witness`` allocates one
(L, n_signals, B) int32 buffer of 12-bit standard-form limbs there (the JAX
package's layout, so the limbs compare directly) and writes each step's
output into it in place. Field products go through ``limbs.mont_mul``: K1 on
a CUDA tensor, its plain version on a CPU tensor. There is one path for
every value: the JAX package's host shortcuts for eager dispatch on a CPU
(Python-int evaluation of small LCs) are not copied, since every value is a
canonical field element and any exact evaluation gives the same limbs.

Non-deterministic hints (circom's ``<--``: long-division q/r, carries) enter
as extra *inputs* computed by host code (``circuits/advice.py``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..core import field as F
from ..core import limbs as LB
from ..device import resolve_device
from ..ops import field_kernels as FK

L = F.LIMBS
P = F.R  # circuit field = Fr
FS = LB.FR_SPEC
W = F.LIMB_BITS
MASK = F.LIMB_MASK


class SignalVec:
    """A (possibly multi-dimensional) array of signal indices."""

    __slots__ = ("idx",)

    def __init__(self, idx: np.ndarray):
        self.idx = np.asarray(idx, dtype=np.int64)

    @property
    def shape(self):
        return self.idx.shape

    @property
    def size(self):
        return self.idx.size

    def __getitem__(self, key) -> "SignalVec":
        return SignalVec(np.asarray(self.idx[key]))

    def reshape(self, *shape) -> "SignalVec":
        return SignalVec(self.idx.reshape(*shape))

    def flat(self) -> "SignalVec":
        return SignalVec(self.idx.reshape(-1))

    def concat(self, other: "SignalVec") -> "SignalVec":
        return SignalVec(np.concatenate([self.idx.reshape(-1), other.idx.reshape(-1)]))

    # --- linear-combination sugar -----------------------------------------
    def lc(self, coeff=1) -> "LC":
        return LC([(self, coeff)])

    def __add__(self, other):
        return self.lc() + other

    def __radd__(self, other):
        return self.lc() + other

    def __sub__(self, other):
        return self.lc() - other

    def __rsub__(self, other):
        return (-1) * self.lc() + other

    def __mul__(self, k):
        if isinstance(k, (int, np.integer, np.ndarray)):
            return self.lc(k)
        raise TypeError("use cs.mul for signal*signal products")

    __rmul__ = __mul__


class LC:
    """Linear combination: list of (SignalVec, coeff) + constant.

    coeff may be a scalar int or a numpy array broadcastable to the signal
    shape. The constant term may likewise be scalar or array.
    """

    __slots__ = ("terms", "const")

    def __init__(self, terms, const=0):
        self.terms = list(terms)
        self.const = const

    @staticmethod
    def of(x) -> "LC":
        if isinstance(x, LC):
            return x
        if isinstance(x, SignalVec):
            return x.lc()
        if isinstance(x, (int, np.integer, np.ndarray)):
            return LC([], x)
        raise TypeError(type(x))

    def __add__(self, other):
        o = LC.of(other)
        return LC(self.terms + o.terms, _addc(self.const, o.const))

    __radd__ = __add__

    def __sub__(self, other):
        o = LC.of(other)
        neg = [(s, _negc(c)) for s, c in o.terms]
        return LC(self.terms + neg, _addc(self.const, _negc(o.const)))

    def __rsub__(self, other):
        o = LC.of(other)
        neg = [(s, _negc(c)) for s, c in self.terms]
        return LC(o.terms + neg, _addc(o.const, _negc(self.const)))

    def __mul__(self, k):
        if isinstance(k, (int, np.integer, np.ndarray)):
            return LC([(s, _mulc(c, k)) for s, c in self.terms], _mulc(self.const, k))
        raise TypeError("use cs.mul for signal*signal products")

    __rmul__ = __mul__

    @property
    def shape(self):
        shp = ()
        for s, c in self.terms:
            shp = np.broadcast_shapes(shp, s.shape, np.shape(c))
        shp = np.broadcast_shapes(shp, np.shape(self.const))
        return shp


def _addc(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a, dtype=object) + np.asarray(b, dtype=object))
    return a + b


def _negc(a):
    if isinstance(a, np.ndarray):
        return -a.astype(object)
    return -a


def _mulc(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a, dtype=object) * np.asarray(b, dtype=object))
    return a * b


@dataclass
class WitnessStep:
    """Computes limb values for out_idx signals: fn(env) -> (L, k, B) int32."""

    out_idx: np.ndarray
    fn: object
    name: str = ""


@dataclass
class InputBinding:
    name: str
    signals: SignalVec
    dtype: str  # "u32" (int array input) | "fr" (limb array input)


class Env:
    """Witness-evaluation environment handed to step functions.

    ``w`` is the (L, n_signals, B) buffer on the evaluation's device, in the
    compiled (publics-first) layout; every gather maps builder indices
    through the circuit's ``perm``. Index tensors and constants move to the
    device once per circuit and device (``consts``), at first use.
    ``syncs`` counts the host syncs that data-dependent branches cost."""

    def __init__(self, w: torch.Tensor, inputs: dict, perm: np.ndarray, consts: dict):
        self.w = w
        self.inputs = inputs
        self.perm = perm
        self.consts = consts
        self.syncs = 0

    @property
    def device(self) -> torch.device:
        return self.w.device

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        """`arr`, a constant the circuit holds, as a tensor on the device."""
        hit = self.consts.get(id(arr))
        if hit is None or hit[0] is not arr:
            hit = (arr, torch.as_tensor(arr, device=self.device))
            self.consts[id(arr)] = hit
        return hit[1]

    def index(self, sv: SignalVec) -> torch.Tensor:
        """The compiled positions of sv's signals (flat), on the device."""
        key = ("index", id(sv))
        hit = self.consts.get(key)
        if hit is None or hit[0] is not sv:
            pos = self.perm[sv.idx.reshape(-1)]
            hit = (sv, torch.as_tensor(pos, dtype=torch.int64, device=self.device))
            self.consts[key] = hit
        return hit[1]

    def fr(self, sv: SignalVec) -> torch.Tensor:
        """Gather signals as Fr limbs: (L, *shape, B)."""
        flat = self.w.index_select(1, self.index(sv))
        return flat.reshape((L,) + sv.shape + (self.w.shape[-1],))

    def u32(self, sv: SignalVec) -> torch.Tensor:
        """Gather signals known to be below 2^36 as int64: (*shape, B)."""
        limbs = self.w[:3].index_select(1, self.index(sv)).long()
        val = limbs[0] | (limbs[1] << W) | (limbs[2] << (2 * W))
        return val.reshape(sv.shape + (self.w.shape[-1],))

    def flag(self, t: torch.Tensor) -> bool:
        """A device boolean on the host: one sync, counted."""
        self.syncs += 1
        return bool(t)


def lift_small(x: torch.Tensor) -> torch.Tensor:
    """Values below 2^12 (*shape) -> (L, *shape) int32 limbs."""
    out = torch.zeros((L,) + tuple(x.shape), dtype=torch.int32, device=x.device)
    out[0] = x
    return out


def lift_u32(x: torch.Tensor) -> torch.Tensor:
    """Nonnegative integers below 2^31 (*shape, B) -> (L, *shape, B) limbs."""
    x = x.long()
    out = torch.zeros((L,) + tuple(x.shape), dtype=torch.int32, device=x.device)
    out[0] = x & MASK
    out[1] = (x >> W) & MASK
    out[2] = (x >> (2 * W)) & 0x7F
    return out


def _negate_where(neg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(neg.unsqueeze(0), FK.subm("Fr", torch.zeros_like(x), x), x)


def limbs_of_i64(x: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """int64 values of magnitude below 2^62 (*shape) -> (L, *shape)
    canonical limbs of x mod p; `signed=False` promises x >= 0."""
    a = x.abs() if signed else x
    out = torch.zeros((L,) + tuple(x.shape), dtype=torch.int32, device=x.device)
    for i in range(-(-62 // W)):
        out[i] = (a >> (i * W)) & MASK
    return _negate_where(x < 0, out) if signed else out


def mul_i64(x: torch.Tensor, y: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """int64 values of magnitude below 2^62 -> (L, ...) canonical limbs of
    x * y mod p: a schoolbook product of six 12-bit limbs each (every
    column sum below 2^27 in int32), exact for any such operands;
    `signed=False` promises x, y >= 0."""
    k = -(-62 // W)
    ax, ay = (x.abs(), y.abs()) if signed else (x, y)
    xl = torch.stack([((ax >> (i * W)) & MASK).to(torch.int32) for i in range(k)])
    yl = torch.stack([((ay >> (i * W)) & MASK).to(torch.int32) for i in range(k)])
    t = torch.zeros((L,) + tuple(x.shape), dtype=torch.int32, device=x.device)
    for i in range(k):
        t[i : i + k] += xl[i] * yl
    out = FK.normalize(t)  # the product is below 2^124 < p: canonical
    return _negate_where((x < 0) ^ (y < 0), out) if signed else out


# Canonical values summed lazily in int32 limbs before one reduction: the
# sum stays below 2^264 (1024 p < 2^264) and each limb below 2^23.
LAZY_TERMS = 1024


def reduce_sum(x: torch.Tensor, dim: int, mont: bool = False) -> torch.Tensor:
    """Sum canonical limb tensors (L, ...) along `dim` mod p with one K1
    product: normalize the lazy int32 sum to 12-bit limbs (a value below
    2^264), then multiply by R mod p (the sum mod p) or by R^2 mod p (its
    Montgomery form)."""
    while x.shape[dim] > LAZY_TERMS:
        parts = torch.split(x, LAZY_TERMS, dim=dim)
        x = torch.stack([reduce_sum(p, dim) for p in parts], dim=dim)
    t = FK.normalize(x.sum(dim=dim, dtype=torch.int32))
    factor = FS.r2_limbs if mont else FS.r_limbs
    return LB.mont_mul(FS, t, LB._col(factor, t.dim(), t.device))


class ConstraintSystem:
    """Accumulates signals, R1CS rows, and the witness plan."""

    def __init__(self, name: str = "circuit"):
        self.name = name
        self.n_signals = 1  # signal 0 is the constant ONE
        self.n_constraints = 0
        # COO triples per matrix: lists of (rows np.int64, cols np.int64, coeffs object)
        self._mats = {"A": [], "B": [], "C": []}
        self.steps: list[WitnessStep] = []
        self.input_bindings: list[InputBinding] = []
        self.public: list[int] = []
        self.one = SignalVec(np.zeros((), dtype=np.int64))
        # constraint/signal spans per named scope — the `snarkjs r1cs info`
        # role (reference records counts by hand, email-verifier.circom:66,86)
        self.scopes: list[tuple[str, int, int, int, int]] = []
        self._scope_stack: list[str] = []

    @contextmanager
    def scope(self, name: str):
        """Label constraints/signals emitted inside with a nested scope path."""
        self._scope_stack.append(name)
        path = "/".join(self._scope_stack)
        c0, s0 = self.n_constraints, self.n_signals
        try:
            yield
        finally:
            self.scopes.append((path, c0, self.n_constraints, s0, self.n_signals))
            self._scope_stack.pop()

    # ---------------------------------------------------------------- alloc
    def alloc(self, shape=(), name: str = "") -> SignalVec:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        idx = np.arange(self.n_signals, self.n_signals + n, dtype=np.int64).reshape(shape)
        self.n_signals += n
        return SignalVec(idx)

    def add_input(self, name: str, shape=(), dtype: str = "u32") -> SignalVec:
        sv = self.alloc(shape, name)
        self.input_bindings.append(InputBinding(name, sv, dtype))

        if dtype == "u32":
            def step(env, name=name, shape=shape):
                x = env.inputs[name]
                return lift_u32(x).reshape((L, sv.size, -1))
        else:
            def step(env, name=name):
                x = env.inputs[name]  # (L, *shape, B) limbs already
                return x.reshape((L, sv.size, -1))

        self.steps.append(WitnessStep(sv.idx.reshape(-1), step, f"input:{name}"))
        return sv

    def mark_public(self, sv: SignalVec):
        self.public.extend(int(i) for i in sv.idx.reshape(-1))

    # ----------------------------------------------------------- constraints
    def _emit(self, mat: str, rows: np.ndarray, lc: LC, shape):
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        store = self._mats[mat]
        for sv, coeff in lc.terms:
            cols = np.broadcast_to(sv.idx, shape).reshape(-1)
            cf = np.broadcast_to(np.asarray(coeff, dtype=object), shape).reshape(-1)
            store.append((rows, cols, cf))
        const = lc.const
        if isinstance(const, np.ndarray) or const != 0:
            cols = np.zeros(n, dtype=np.int64)
            cf = np.broadcast_to(np.asarray(const, dtype=object), shape).reshape(-1)
            store.append((rows, cols, cf))

    def enforce(self, a, b, c):
        """Add constraints  a * b = c  (elementwise over broadcast shape)."""
        a, b, c = LC.of(a), LC.of(b), LC.of(c)
        shape = np.broadcast_shapes(a.shape, b.shape, c.shape)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        rows = np.arange(self.n_constraints, self.n_constraints + n, dtype=np.int64)
        self.n_constraints += n
        self._emit("A", rows, a, shape)
        self._emit("B", rows, b, shape)
        self._emit("C", rows, c, shape)

    def enforce_zero(self, lc):
        self.enforce(lc, LC([], 1), LC([], 0))

    def enforce_equal(self, a, b):
        self.enforce(LC.of(a) - LC.of(b), LC([], 1), LC([], 0))

    def enforce_bit(self, sv):
        self.enforce(sv, LC.of(sv) - 1, LC([], 0))

    # ------------------------------------------------------- witness helpers
    def set_witness(self, sv: SignalVec, fn, name: str = ""):
        """fn(env) -> (L, k, B) limb values for sv.flat()."""
        self.steps.append(WitnessStep(sv.idx.reshape(-1), fn, name))


    def define(self, lc, name: str = "") -> SignalVec:
        """z = lc with a generic witness evaluation (use for small gadgets)."""
        lc = LC.of(lc)
        shape = lc.shape
        z = self.alloc(shape, name)
        self.enforce_equal(lc, z)
        prep = PreparedLC(lc, shape)

        def step(env, prep=prep):
            return prep.eval(env)

        self.set_witness(z, step, name or "define")
        return z

    def mul(self, a, b, name: str = "") -> SignalVec:
        """z = a * b (signal product) with generic witness computation."""
        a, b = LC.of(a), LC.of(b)
        shape = np.broadcast_shapes(a.shape, b.shape)
        z = self.alloc(shape, name)
        self.enforce(a, b, z)
        prep_a = PreparedLC(a, shape)
        prep_b = PreparedLC(b, shape)

        def step(env, prep_a=prep_a, prep_b=prep_b):
            return mul_lcs(env, prep_a, prep_b)

        self.set_witness(z, step, name or "mul")
        return z

    # ------------------------------------------------------------- compile
    def compile(self) -> "CompiledCircuit":
        return CompiledCircuit(self)


class PreparedLC:
    """An LC in gather form: every term broadcast to the LC's shape, so one
    index matrix (T, n) gathers all T terms at once, with its coefficients
    and constant precomputed at build time.

    Evaluation takes one of two exact paths. The int64 path runs when every
    coefficient and the constant are small (static) and every gathered value
    fits three limbs, below 2^36 (one host sync); the bound checked here
    keeps the signed sum below 2^62. Otherwise the field path multiplies the
    gathered values by their coefficients (one K1 launch, skipped when all
    coefficients are 1), sums lazily and reduces (one K1 launch)."""

    SMALL_COEFF = 1 << 20

    def __init__(self, lc: "LC", shape=None):
        lc = LC.of(lc)
        self.shape = tuple(lc.shape if shape is None else shape)
        self.n = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
        idx, cfs = [], []
        for sv, coeff in lc.terms:
            pad = len(self.shape) - len(sv.shape)
            idx.append(np.broadcast_to(
                sv.idx.reshape((1,) * pad + sv.shape), self.shape).reshape(-1))
            cfs.append(np.broadcast_to(
                np.asarray(coeff, dtype=object), self.shape).reshape(-1))
        self.terms = SignalVec(np.stack(idx) if idx else np.zeros((0, self.n), np.int64))
        cf = np.stack(cfs) % P if cfs else np.zeros((0, self.n), dtype=object)
        const = np.broadcast_to(np.asarray(lc.const, dtype=object), self.shape).reshape(-1) % P
        self.unit = bool((cf == 1).all())
        self.cf = cf  # (T, n) Python ints in [0, P)
        self.const = const if any(int(c) for c in const) else None
        self.small_cf = np.ones(cf.shape, np.int64) if self.unit else _small_of(cf)
        self.small_const = None if self.const is None else _small_of(self.const)
        bound = 0
        small_ok = self.small_cf is not None
        if small_ok:
            bound = int(sum(int(np.abs(r).max(initial=1)) for r in self.small_cf)) << 36
        if self.const is not None:
            if self.small_const is None:
                small_ok = False
            else:
                bound += int(np.abs(self.small_const).max(initial=0))
        self.small_ok = small_ok and bound < (1 << 62)
        # the int64 value cannot be negative: no coefficient or constant is
        self.signed = self.small_ok and bool(
            (self.small_cf < 0).any()
            or (self.small_const is not None and (self.small_const < 0).any())
        )
        self._cf_mont = None
        self._const_std = None

    def gather(self, env: Env) -> torch.Tensor:
        """(L, T, n, B) limbs of every term's signals."""
        g = env.w.index_select(1, env.index(self.terms))
        return g.reshape(L, self.terms.shape[0], self.n, env.w.shape[-1])

    @staticmethod
    def wide(g: torch.Tensor) -> torch.Tensor:
        """Device boolean: some gathered value is 2^36 or more."""
        return (g[3:] != 0).any()

    def eval_i64(self, env: Env, g: torch.Tensor) -> torch.Tensor:
        """(n, B) signed int64 value of the LC, its terms below 2^36."""
        v = g[0].long() | (g[1].long() << W) | (g[2].long() << (2 * W))
        acc = v.sum(0) if self.unit else (env.tensor(self.small_cf)[..., None] * v).sum(0)
        if self.small_const is not None:
            acc = acc + env.tensor(self.small_const)[:, None]
        return acc

    def eval_field(self, env: Env, g: torch.Tensor, mont: bool = False) -> torch.Tensor:
        """(L, n, B) canonical limbs of the LC (Montgomery form if `mont`)."""
        if self._cf_mont is None:
            mont_cf = np.vectorize(F.FR.to_mont, otypes=[object])(self.cf)
            self._cf_mont = LB.ints_to_limbs(mont_cf)[..., None]  # (L, T, n, 1)
            if self.const is not None:
                self._const_std = LB.ints_to_limbs(self.const)[:, None, :, None]
        terms = g if self.unit else LB.mont_mul(FS, g, env.tensor(self._cf_mont))
        if self.const is not None:
            c = env.tensor(self._const_std).expand((L, 1) + tuple(g.shape[2:]))
            terms = torch.cat([terms, c], dim=1)
        if terms.shape[1] == 0:
            return torch.zeros((L,) + tuple(g.shape[2:]), dtype=torch.int32, device=g.device)
        return reduce_sum(terms, 1, mont=mont)

    def eval(self, env: Env, mont: bool = False) -> torch.Tensor:
        """(L, n, B) canonical limbs of the LC (Montgomery form if `mont`)."""
        g = self.gather(env)
        if self.small_ok and not env.flag(self.wide(g)):
            out = limbs_of_i64(self.eval_i64(env, g), self.signed)
            return LB.to_mont(FS, out) if mont else out
        return self.eval_field(env, g, mont)


def _small_of(cf: np.ndarray):
    """Python ints in [0, P) -> the int64 signed residues of magnitude below
    SMALL_COEFF, or None when one is not that small."""
    flat = cf.reshape(-1)
    out = np.zeros(flat.shape, dtype=np.int64)
    for i, c in enumerate(flat):
        c = int(c)
        if c < PreparedLC.SMALL_COEFF:
            out[i] = c
        elif c > P - PreparedLC.SMALL_COEFF:
            out[i] = c - P
        else:
            return None
    return out.reshape(cf.shape)


def mul_lcs(env: Env, a: PreparedLC, b: PreparedLC) -> torch.Tensor:
    """(L, n, B) canonical limbs of a * b: exact int64 limb products when
    both LCs take the int64 path (one host sync for both), else a K1 product
    of a's Montgomery form and b."""
    ga, gb = a.gather(env), b.gather(env)
    if a.small_ok and b.small_ok and not env.flag(a.wide(ga) | b.wide(gb)):
        return mul_i64(a.eval_i64(env, ga), b.eval_i64(env, gb), a.signed or b.signed)
    return LB.mont_mul(FS, a.eval_field(env, ga, mont=True), b.eval_field(env, gb))


class CompiledCircuit:
    """Frozen circuit: permuted R1CS (publics first) + the witness plan.

    Carries the attributes the port's ``groth16_setup`` and ``prove_batch``
    read of an R1CS (``name``, ``A``/``B``/``C`` triples, ``n_constraints``,
    ``n_signals``, ``n_public`` and a ``cache`` for derived tensors)."""

    def __init__(self, cs: ConstraintSystem):
        self.name = cs.name
        self.n_constraints = cs.n_constraints
        self.n_signals = cs.n_signals
        self.n_public = len(cs.public)
        # permutation: old index -> new index; publics occupy 1..n_pub
        perm = np.full(cs.n_signals, -1, dtype=np.int64)
        perm[0] = 0
        nxt = 1
        for p in cs.public:
            if perm[p] == -1:
                perm[p] = nxt
                nxt += 1
        self.n_public = nxt - 1
        for i in range(cs.n_signals):
            if perm[i] == -1:
                perm[i] = nxt
                nxt += 1
        self.perm = perm

        def pack(mat):
            rows = np.concatenate([r for r, _, _ in mat]) if mat else np.zeros(0, np.int64)
            cols = np.concatenate([c for _, c, _ in mat]) if mat else np.zeros(0, np.int64)
            cf = (
                np.concatenate([np.asarray(v, dtype=object) for _, _, v in mat])
                if mat
                else np.zeros(0, dtype=object)
            )
            cols = perm[cols]
            # drop zero coefficients
            nz = np.array([int(x) % P != 0 for x in cf], dtype=bool)
            return rows[nz], cols[nz], np.array([int(x) % P for x in cf[nz]], dtype=object)

        self.A = pack(cs._mats["A"])
        self.B = pack(cs._mats["B"])
        self.C = pack(cs._mats["C"])
        self.steps = cs.steps
        self.input_bindings = cs.input_bindings
        self.scopes = list(cs.scopes)
        # per-device tensors: the prover's (prover/groth16.py, setup.py) and
        # the witness steps' constants (Env.consts), keyed by device
        self.cache = {}
        # writeback targets: signals are allocated sequentially, so
        # perm[out_idx] is almost always a contiguous run, written as a slice
        self._wb = []
        for st in self.steps:
            pidx = perm[st.out_idx]
            if len(pidx) and (np.diff(pidx) == 1).all():
                self._wb.append(slice(int(pidx[0]), int(pidx[0]) + len(pidx)))
            else:
                self._wb.append(SignalVec(st.out_idx))

    # ------------------------------------------------------------ witness
    @torch.inference_mode()
    def eval_witness(self, inputs: dict, batch: int, device=None,
                     stats: dict | None = None) -> torch.Tensor:
        """The full witness (L, n_signals, batch), permuted layout, standard
        form, computed on `device` (default: CUDA) from `inputs`, tensors on
        that device (``models/input_bridge.py::prepare_inputs``).

        `stats`, when given, receives ``syncs`` (the host syncs of
        data-dependent branches) and ``steps_s``: seconds by step kind (the
        step name up to its first ':'), the device synchronized after each
        step."""
        dev = resolve_device(device)
        for name, x in inputs.items():
            if x.device != dev:
                raise ValueError(f"input {name} lives on {x.device}, witness asked for {dev}")
        consts = self.cache.setdefault(("witness", str(dev)), {})
        w = torch.zeros((L, self.n_signals, batch), dtype=torch.int32, device=dev)
        w[0, 0, :] = 1  # ONE
        env = Env(w, inputs, self.perm, consts)
        sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                else (lambda: None))
        steps_s = {}
        for step, wb in zip(self.steps, self._wb):
            t0 = time.time()
            vals = step.fn(env).reshape(L, len(step.out_idx), batch)
            if isinstance(wb, slice):
                w[:, wb, :] = vals
            else:
                w[:, env.index(wb), :] = vals
            if stats is not None:
                sync()
                kind = step.name.split(":")[0]
                steps_s[kind] = steps_s.get(kind, 0.0) + time.time() - t0
        if stats is not None:
            stats["syncs"] = env.syncs
            stats["steps_s"] = steps_s
        return w

    # ------------------------------------------------------------ checking
    def check_satisfied_host(self, witness_ints) -> bool:
        """Python-int R1CS satisfaction check (tests; small circuits)."""
        w = [int(x) % P for x in witness_ints]

        def eval_mat(mat):
            rows, cols, cf = mat
            out = [0] * self.n_constraints
            for r, c, v in zip(rows, cols, cf):
                out[int(r)] = (out[int(r)] + int(v) * w[int(c)]) % P
            return out

        aw, bw, cw = eval_mat(self.A), eval_mat(self.B), eval_mat(self.C)
        return all(aw[i] * bw[i] % P == cw[i] for i in range(self.n_constraints))
