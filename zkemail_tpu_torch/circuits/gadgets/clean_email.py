"""CleanEmailAddress: gmail dot/plus-alias normalization in-circuit.

Parity target: zk-email-verify packages/circuits/utils/email.circom:16 —
removes '.' in the local part and strips '+tag' suffixes (everything from
'+' up to '@'), proving encoded/decoded equivalence via a random linear
combination with r = Poseidon(pack(encoded) || pack(decoded))
(email.circom:44-51,101-139). A copy of the JAX package's module.
"""

from __future__ import annotations

import numpy as np

from ..builder import LC, ConstraintSystem, SignalVec
from .basic import is_equal
from .bytes import pack_bytes
from .poseidon_gadget import poseidon_modular


def clean_email_address(
    cs: ConstraintSystem, encoded: SignalVec, decoded: SignalVec
) -> SignalVec:
    """Assert `decoded` == `encoded` with local-part dots removed and the
    '+tag' section dropped. Returns the RLC challenge signal."""
    n = encoded.shape[0]
    assert decoded.shape[0] == n

    packed = pack_bytes(cs, SignalVec(np.concatenate([encoded.idx, decoded.idx])))
    r = poseidon_modular(cs, packed)

    eq_at = is_equal(cs, encoded, LC([], ord("@")))      # (n,)
    eq_dot = is_equal(cs, encoded, LC([], ord(".")))
    eq_plus = is_equal(cs, encoded, LC([], ord("+")))

    # cumulative "seen @" and "inside +tag" indicators
    after_at: list = []   # true strictly AFTER the '@' position? include '@' itself as kept
    in_plus: list = []    # '+' seen and '@' not yet seen (the '+' char included)
    prev_at = LC([], 0)
    prev_plus = LC([], 0)
    for i in range(n):
        # seen_at_i = prev_at OR at_i  (at position i, true FROM the @ onwards)
        t = cs.mul(prev_at, eq_at[i].lc(), "cea_or")
        seen_at = cs.define(prev_at + eq_at[i].lc() - t.lc(), "cea_seenat")
        # in_plus resets at '@': in_plus_i = (prev_plus OR plus_i) AND NOT seen_at
        t2 = cs.mul(prev_plus, eq_plus[i].lc(), "cea_or2")
        plus_or = prev_plus + eq_plus[i].lc() - t2.lc()
        ip = cs.mul(plus_or, 1 - LC.of(seen_at), "cea_inplus")
        after_at.append(LC.of(seen_at))
        in_plus.append(LC.of(ip))
        prev_at = LC.of(seen_at)
        prev_plus = LC.of(ip)

    # removed_i: dot before '@', or inside the +tag section (and not the '@')
    # kept_i = 1 - removed_i
    lhs = LC([], 0)
    cur = LC([], 1)
    for i in range(n):
        dot_local = cs.mul(eq_dot[i], 1 - after_at[i], "cea_dotlocal")
        # in_plus includes '@'? no: in_plus is AND NOT seen_at, and seen_at is
        # true at the '@' itself, so '@' is kept.
        removed = LC.of(dot_local) + in_plus[i]
        kept = 1 - removed
        contrib = cs.mul(cur, kept, "cea_keptpow")
        term = cs.mul(contrib.lc(), encoded[i], "cea_term")
        lhs = lhs + term
        cr = cs.mul(contrib.lc(), r, "cea_cr")
        nxt = cs.define(cur - contrib.lc() + cr, "cea_pow")
        cur = LC.of(nxt)

    rhs = LC([], 0)
    rp = LC([], 1)
    for j in range(n):
        term = cs.mul(rp, decoded[j], "cea_dterm")
        rhs = rhs + term
        if j < n - 1:
            rp_next = cs.mul(rp, r, "cea_rp")
            rp = LC.of(rp_next)
    cs.enforce_equal(lhs, rhs)
    return r


def clean_email_host(address: bytes) -> bytes:
    """Host reference of the same normalization (zero-padded to input length)."""
    if b"@" in address.rstrip(b"\x00"):
        local, rest = address.split(b"@", 1)
    else:
        local, rest = address, None
    local = local.replace(b".", b"")
    if b"+" in local:
        local = local.split(b"+", 1)[0]
    out = local + (b"@" + rest if rest is not None else b"")
    return out[: len(address)] + b"\x00" * (len(address) - len(out))
