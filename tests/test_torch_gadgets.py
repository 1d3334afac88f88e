"""The port's circuit builder and gadgets against the JAX package's.

Each case builds one tiny circuit by the same calls in both packages and
evaluates its witness on the same inputs (B = 2, made from a seed with
numpy): the compiled R1CS must be identical (counts, ``perm``, the A/B/C
triples) and the port's witness on the CPU must equal the JAX
``eval_witness`` limb for limb. Tolerance: exact equality."""

import base64
import hashlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkemail_tpu.circuits.builder as j_builder
import zkemail_tpu.circuits.regex_compiler as j_regex
import zkemail_tpu.circuits.gadgets.base64 as j_b64
import zkemail_tpu.circuits.gadgets.basic as j_basic
import zkemail_tpu.circuits.gadgets.poseidon_gadget as j_pos
import zkemail_tpu.circuits.gadgets.regex_dfa as j_dfa
import zkemail_tpu.circuits.gadgets.sha_wrappers as j_sha
import zkemail_tpu_torch.circuits.builder as t_builder
import zkemail_tpu_torch.circuits.regex_compiler as t_regex
import zkemail_tpu_torch.circuits.gadgets.base64 as t_b64
import zkemail_tpu_torch.circuits.gadgets.basic as t_basic
import zkemail_tpu_torch.circuits.gadgets.poseidon_gadget as t_pos
import zkemail_tpu_torch.circuits.gadgets.regex_dfa as t_dfa
import zkemail_tpu_torch.circuits.gadgets.sha_wrappers as t_sha
from zkemail_tpu_torch.core import field as F
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.poseidon import poseidon_large
from zkemail_tpu_torch.helpers import sha_utils as SU

torch.set_num_threads(1)

JAX = types.SimpleNamespace(builder=j_builder, basic=j_basic, sha=j_sha, pos=j_pos,
                            dfa=j_dfa, regex=j_regex, b64=j_b64)
PORT = types.SimpleNamespace(builder=t_builder, basic=t_basic, sha=t_sha, pos=t_pos,
                             dfa=t_dfa, regex=t_regex, b64=t_b64)
B = 2


def run_both(build, inputs: dict, fr_names=()):
    """Build with both packages, compare the R1CS, evaluate both witnesses
    on `inputs` (numpy int arrays with a trailing batch axis; the names in
    fr_names hold Python ints, sent as limbs). Returns (port circuit, port
    handles, port witness as numpy)."""
    out = {}
    for tag, ns in (("jax", JAX), ("port", PORT)):
        cs = ns.builder.ConstraintSystem("gadget")
        handles = build(ns, cs)
        out[tag] = (cs.compile(), handles)
    jcc, tcc = out["jax"][0], out["port"][0]
    assert (jcc.n_constraints, jcc.n_signals, jcc.n_public) == (
        tcc.n_constraints, tcc.n_signals, tcc.n_public)
    assert np.array_equal(jcc.perm, tcc.perm)
    for m in "ABC":
        for x, y in zip(getattr(jcc, m), getattr(tcc, m)):
            assert x.dtype == y.dtype and np.array_equal(x, y), m
    arrs = {k: LB.ints_to_limbs(v) if k in fr_names else np.asarray(v, np.int32)
            for k, v in inputs.items()}
    jw = np.asarray(jcc.eval_witness({k: jnp.asarray(v) for k, v in arrs.items()}, B))
    tw = tcc.eval_witness({k: torch.as_tensor(v) for k, v in arrs.items()}, B,
                          device="cpu").numpy()
    assert tw.shape == jw.shape and tw.dtype == np.int32
    assert np.array_equal(tw, jw)
    for b in range(B):
        assert tcc.check_satisfied_host(LB.limbs_to_ints(tw[:, :, b]))
    return tcc, out["port"][1], tw


def values(cc, w, sv, b):
    """Field values of signal vector `sv` in batch column b."""
    return [int(v) for v in LB.limbs_to_ints(w[:, cc.perm[sv.idx.reshape(-1)], b])]


def test_num2bits_and_comparators():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 16, size=(6, B))
    y = x.copy()
    x[0] = 0  # is_zero on 0
    y[1] = rng.integers(0, 1 << 16, size=B)  # unequal and either order
    y[2] = x[2] + 1

    def build(ns, cs):
        xs = cs.add_input("x", (6,))
        ys = cs.add_input("y", (6,))
        bits = ns.basic.num2bits(cs, xs, 16)
        z = ns.basic.is_zero(cs, xs)
        eq = ns.basic.is_equal(cs, xs, ys)
        lt = ns.basic.less_than(cs, xs, ys, 16)
        ge = ns.basic.greater_eq_than(cs, xs, ys, 16)
        cs.mark_public(lt)
        return bits, z, eq, lt, ge

    cc, (bits, z, eq, lt, ge), w = run_both(build, {"x": x, "y": y})
    for b in range(B):
        xb, yb = [int(v) for v in x[:, b]], [int(v) for v in y[:, b]]
        assert values(cc, w, z, b) == [int(v == 0) for v in xb]
        assert values(cc, w, eq, b) == [int(u == v) for u, v in zip(xb, yb)]
        assert values(cc, w, lt, b) == [int(u < v) for u, v in zip(xb, yb)]
        assert values(cc, w, ge, b) == [int(u >= v) for u, v in zip(xb, yb)]
        assert values(cc, w, bits[3], b) == [(v >> 3) & 1 for v in xb]


def test_mul_small_negative_and_full_field():
    rng = np.random.default_rng(12)
    small = rng.integers(0, 1 << 30, size=(4, B))
    big = np.array([[int(rng.integers(0, 1 << 62)) * (1 << 190) % F.R + k for k in range(B)]
                    for _ in range(4)], dtype=object)

    def build(ns, cs):
        s = cs.add_input("s", (4,))
        f = cs.add_input("f", (4,), dtype="fr")
        L = ns.builder.LC
        outs = [
            cs.mul(s, s),  # int64 path, products up to 2^60
            cs.mul(s - 7 * (1 << 30), s + 3),  # negative int64 operand
            cs.mul(f, s),  # full-field operand: K1 path
            cs.mul(f * (F.R - 5) + 11, f),  # large coefficient: field path
            cs.define(L([(s, 1 << 19), (s, -3)], 12345)),
            cs.define(f + s * (1 << 100)),
        ]
        return outs

    cc, outs, w = run_both(build, {"s": small, "f": big}, fr_names={"f"})
    p = F.R
    for b in range(B):
        s = [int(v) for v in small[:, b]]
        f = [int(v) for v in big[:, b]]
        assert values(cc, w, outs[0], b) == [v * v % p for v in s]
        assert values(cc, w, outs[1], b) == [(v - 7 * (1 << 30)) * (v + 3) % p for v in s]
        assert values(cc, w, outs[2], b) == [u * v % p for u, v in zip(f, s)]
        assert values(cc, w, outs[3], b) == [(u * (p - 5) + 11) * u % p for u in f]
        assert values(cc, w, outs[4], b) == [(v * ((1 << 19) - 3) + 12345) % p for v in s]
        assert values(cc, w, outs[5], b) == [(u + v * (1 << 100)) % p for u, v in zip(f, s)]


def _sha_inputs(max_len, messages):
    data = np.zeros((max_len, B), dtype=np.int64)
    lens = np.zeros((B,), dtype=np.int64)
    for b, msg in enumerate(messages):
        padded, plen = SU.sha256_pad(msg, max_len)
        data[:, b] = np.frombuffer(padded, dtype=np.uint8)
        lens[b] = plen
    return data, lens


def _digest(cc, w, bits, b) -> bytes:
    v = values(cc, w, bits, b)  # (8, 32) LSB-first word bits
    return b"".join(
        sum(v[32 * wi + j] << j for j in range(32)).to_bytes(4, "big") for wi in range(8)
    )


def test_sha256_bytes_two_blocks():
    rng = np.random.default_rng(13)
    msgs = [rng.bytes(100), rng.bytes(20)]  # 2 blocks and 1 block of 2
    data, lens = _sha_inputs(128, msgs)

    def build(ns, cs):
        d = cs.add_input("data", (128,))
        n = cs.add_input("len", ())
        digest, _ = ns.sha.sha256_bytes(cs, d, n)
        hi, lo = ns.sha.pack_digest_hi_lo(cs, digest)
        cs.mark_public(hi)
        cs.mark_public(lo)
        return digest

    cc, digest, w = run_both(build, {"data": data, "len": lens})
    for b, msg in enumerate(msgs):
        assert _digest(cc, w, digest, b) == hashlib.sha256(msg).digest()


def test_sha256_bytes_partial_with_midstate():
    rng = np.random.default_rng(14)
    msgs = [rng.bytes(64 + 40), rng.bytes(64 + 70)]
    data = np.zeros((128, B), dtype=np.int64)
    lens = np.zeros((B,), dtype=np.int64)
    mids = np.zeros((32, B), dtype=np.int64)
    for b, msg in enumerate(msgs):
        padded, plen = SU.sha256_pad(msg, 192)
        mids[:, b] = np.frombuffer(SU.partial_sha(padded[:64]), dtype=np.uint8)
        rest = padded[64:192]
        data[:, b] = np.frombuffer(rest, dtype=np.uint8)
        lens[b] = plen - 64

    def build(ns, cs):
        d = cs.add_input("data", (128,))
        n = cs.add_input("len", ())
        mid = cs.add_input("mid", (32,))
        digest, _ = ns.sha.sha256_bytes_partial(cs, d, n, mid)
        return digest

    cc, digest, w = run_both(build, {"data": data, "len": lens, "mid": mids})
    for b, msg in enumerate(msgs):
        assert _digest(cc, w, digest, b) == hashlib.sha256(msg).digest()


def test_poseidon_large_17_limbs():
    rng = np.random.default_rng(15)
    mods = [int.from_bytes(rng.bytes(256), "big") | (1 << 2047) for _ in range(B)]
    limbs = np.array([[(m >> (121 * i)) & ((1 << 121) - 1) for m in mods]
                      for i in range(17)], dtype=object)

    def build(ns, cs):
        x = cs.add_input("x", (17,), dtype="fr")
        h = ns.pos.poseidon_large(cs, x)
        cs.mark_public(h)
        return h

    cc, h, w = run_both(build, {"x": limbs}, fr_names={"x"})
    for b, m in enumerate(mods):
        assert values(cc, w, h, b) == [poseidon_large(m, 121, 9)]


def test_dfa_match_gadget_short_header():
    headers = [
        b"to:a@b.c\r\ndkim-signature:v=1; bh=QUJDREVGR0g=; b=xyz\r\n",
        b"subject:bh=NOTME;\r\ndkim-signature:a=rsa; bh=Zm9vYmFy+/==; b=\r\n",
    ]
    data = np.zeros((64, B), dtype=np.int64)
    for b, hd in enumerate(headers):
        data[: len(hd), b] = np.frombuffer(hd, dtype=np.uint8)

    def build(ns, cs):
        dfa = ns.regex.compile_regex(
            ns.regex.BODY_HASH_ANCHORED_PATTERN,
            reveal_groups={ns.regex.BODY_HASH_REVEAL_GROUP}, anchored=False)
        d = cs.add_input("data", (64,))
        match, reveal = ns.dfa.dfa_match_gadget(
            cs, d, dfa, reveal_tags=[ns.regex.BODY_HASH_REVEAL_GROUP],
            initial_state=ns.regex.dfa_state_after(dfa, b"\r\n"))
        cs.mark_public(match)
        return match, reveal

    cc, (match, reveal), w = run_both(build, {"data": data})
    for b, hd in enumerate(headers):
        assert values(cc, w, match, b) == [1]
        revealed = bytes(v for v in values(cc, w, reveal, b) if v)
        assert revealed == hd.split(b"dkim-signature:")[1].split(b"bh=")[1].split(b";")[0]


def test_base64_decode():
    rng = np.random.default_rng(16)
    raw = [rng.bytes(32) for _ in range(B)]
    chars = np.array([list(base64.b64encode(r)) for r in raw], dtype=np.int64).T  # (44, B)

    def build(ns, cs):
        c = cs.add_input("chars", (44,))
        out = ns.b64.base64_decode(cs, c, 32)
        return out

    cc, out, w = run_both(build, {"chars": chars})
    for b, r in enumerate(raw):
        assert bytes(values(cc, w, out, b)) == r


def test_witness_runs_on_cuda_unless_told():
    """The default device is CUDA: without a card the witness raises; with
    one, CPU inputs are refused (they do not move)."""
    cs = t_builder.ConstraintSystem("dev")
    x = cs.add_input("x", (2,))
    t_basic.num2bits(cs, x, 4)
    cc = cs.compile()
    inputs = {"x": torch.zeros((2, 1), dtype=torch.int32)}
    with pytest.raises((RuntimeError, ValueError)):
        cc.eval_witness(inputs, 1)
    assert cc.eval_witness(inputs, 1, device="cpu").shape == (F.LIMBS, cc.n_signals, 1)
