"""The port's benchmark subcircuits (``models/subcircuits.py``) against the
JAX package's, on the CPU, at the sizes of tests/test_subcircuits.py:
``build_sha_bench(128)``, ``build_rsa_bench()`` and
``build_email_reveal_bench(448, 192, 32)``.

Each builder gives the JAX R1CS; on the same inputs (a batch of two, made
from a seeded signer: one valid column and one tampered column) the port's
witness equals the JAX ``eval_witness`` limb for limb, the publics are the
host's values, the valid column satisfies the R1CS and the tampered one
does not. ``subcircuit_inputs`` gives the arrays ``bench.py``'s JAX
``subcircuit_inputs`` feeds for sha640 and rsa2048, and ``reveal_window``
its revealStart / revealLength. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from zkemail_tpu.models import subcircuits as JS
from zkemail_tpu.models.email_verifier import EmailVerifierConfig as JConfig
from zkemail_tpu.models.input_bridge import prepare_inputs as j_prepare
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.poseidon import poseidon_large
from zkemail_tpu_torch.helpers import sha_utils as SU
from zkemail_tpu_torch.helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner
from zkemail_tpu_torch.models import subcircuits as TS
from zkemail_tpu_torch.models.email_verifier import EmailVerifierConfig
from zkemail_tpu_torch.models.input_bridge import prepare_inputs

torch.set_num_threads(2)

B = 2


@pytest.fixture(scope="module")
def signer():
    return LocalDKIMSigner(seed=11)


def both(jcs, tcs, inputs: dict, satisfied=(True, False)):
    """Compile both circuits, compare the R1CS and the witnesses on
    `inputs` (numpy int32 arrays); returns (port circuit, port witness)."""
    jcc, cc = jcs.compile(), tcs.compile()
    assert (jcc.name, jcc.n_constraints, jcc.n_signals, jcc.n_public) == (
        cc.name, cc.n_constraints, cc.n_signals, cc.n_public)
    assert np.array_equal(jcc.perm, cc.perm)
    for m in "ABC":
        for x, y in zip(getattr(jcc, m), getattr(cc, m)):
            assert x.dtype == y.dtype and np.array_equal(x, y), m
    jw = np.asarray(jcc.eval_witness({k: jnp.asarray(v) for k, v in inputs.items()}, B))
    w = cc.eval_witness({k: torch.as_tensor(v) for k, v in inputs.items()}, B,
                        device="cpu").numpy()
    assert np.array_equal(w, jw)
    for b, want in enumerate(satisfied):
        assert cc.check_satisfied_host(LB.limbs_to_ints(w[:, :, b])) is want
    return cc, w


def publics(cc, w, b):
    return [int(v) for v in LB.limbs_to_ints(w[:, 1 : cc.n_public + 1, b])]


def test_sha_bench():
    messages = [b"bench subcircuit sha parity", b"a second header, 64 bytes and more " * 2]
    data = np.zeros((128, B), dtype=np.int32)
    lens = np.zeros((B,), dtype=np.int32)
    for b, msg in enumerate(messages):
        padded, plen = SU.sha256_pad(msg, 128)
        data[:, b] = np.frombuffer(padded, dtype=np.uint8)
        lens[b] = plen
    cc, w = both(JS.build_sha_bench(128), TS.build_sha_bench(128),
                 {"emailHeader": data, "emailHeaderLength": lens}, satisfied=(True, True))
    for b, msg in enumerate(messages):
        digest = SU.sha256(msg)
        assert publics(cc, w, b) == [int.from_bytes(digest[:16], "big"),
                                     int.from_bytes(digest[16:], "big")]


@pytest.mark.parametrize("name", ["sha640", "rsa2048"])
def test_subcircuit_inputs_equal_bench(signer, name):
    """The port's subcircuit_inputs is bench.py's on the same signer."""
    assert TS.CONFIGS == bench.CONFIGS
    spec = bench.CONFIGS[name]
    want = bench.subcircuit_inputs(spec["kind"], spec, B, signer)
    got = TS.subcircuit_inputs(spec["kind"], spec, B, signer, device="cpu")
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].device == torch.device("cpu")
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    digests = [TS.digest_to_bits(bytes(range(i, i + 32))) for i in range(3)]
    assert all(np.array_equal(d, JS.digest_to_bits(bytes(range(i, i + 32))))
               for i, d in enumerate(digests))


def test_rsa_bench(signer):
    """rsa2048 at its one size: column 1's digest has one bit flipped, so
    its signature check fails."""
    inputs = {k: v.numpy() for k, v in
              TS.subcircuit_inputs("rsa", {}, B, signer, device="cpu").items()}
    inputs["digestBits"][0, 0, 1] ^= 1
    cc, w = both(JS.build_rsa_bench(), TS.build_rsa_bench(), inputs)
    digest = SU.sha256(bench_header(signer, 0))
    assert publics(cc, w, 0) == [poseidon_large(signer.public_key[0], 121, 9),
                                 int.from_bytes(digest[:16], "big"),
                                 int.from_bytes(digest[16:], "big")]


def bench_header(signer, i):
    """The canonicalized signed header of the benchmark's email i."""
    from zkemail_tpu_torch.helpers.dkim import verify_dkim_signature

    return verify_dkim_signature(TS.bench_emails(signer, i + 1)[i], signer.resolver()).headers


def test_email_reveal_bench(signer):
    """EmailVerifier + substring reveal at 448/192: the revealed subject is
    packed 31 bytes a field into the tail publics; column 1's window starts
    past the header's end and is refused."""
    hl, bl = 448, 192
    args = InputGenArgs(max_headers_length=hl, max_body_length=bl)
    raws = [generate_email_verifier_inputs(e, signer.resolver(), args)
            for e in TS.bench_emails(signer, B)]
    cfg = EmailVerifierConfig(max_headers_length=hl, max_body_length=bl)
    inputs = {k: v.numpy() for k, v in prepare_inputs(raws, cfg, device="cpu").items()}
    j_inputs = j_prepare(raws, JConfig(max_headers_length=hl, max_body_length=bl))
    for k in inputs:
        assert np.array_equal(inputs[k], np.asarray(j_inputs[k])), k
    window = {k: v.numpy() for k, v in TS.reveal_window(raws, device="cpu").items()}
    for i, raw in enumerate(raws):
        hdr = bytes(int(v) for v in raw["emailHeader"])
        needle = f"subject:bench email {i}".encode()
        assert hdr[window["revealStart"][i]:][: window["revealLength"][i]] == needle
    inputs.update(window)
    inputs["revealStart"][1] = hl
    cc, w = both(JS.build_email_reveal_bench(hl, bl, 32), TS.build_email_reveal_bench(hl, bl, 32),
                 inputs)
    assert cc.n_public == 3 + 2
    window0 = b"subject:bench email 0".ljust(62, b"\x00")
    assert publics(cc, w, 0)[3:] == [int.from_bytes(window0[:31], "little"),
                                     int.from_bytes(window0[31:], "little")]
    with pytest.raises(ValueError, match="subject not found"):
        TS.reveal_window(raws[1:], device="cpu")
