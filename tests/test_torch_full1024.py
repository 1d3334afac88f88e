"""The port at bench.py's full1024 config against the JAX package, on the CPU.

full1024 is the EmailVerifier at header 1024 and body 1536 bytes with the
body-hash check: the reference's default padded sizes, and with full4kb
(``tests/test_torch_full4kb.py``, which reuses ``parity_run``) the largest
of bench.py's configs, on a 2^22 domain. For the config:

  * the compiled R1CS equals the JAX package's: the counts, the signal
    permutation, every (row, column, coefficient) entry of A, B and C and
    the witness steps;
  * on one of bench.py's emails (``bench_emails``) and on one seeded email
    whose body fills most of the body length (``long_body_email``), the
    port's ``generate_email_verifier_inputs`` and ``prepare_inputs`` give
    the JAX package's values;
  * the port's CPU witness of the long-body email at B = 1 equals the JAX
    ``eval_witness`` (its host path) limb for limb, and its publics are the
    host's Poseidon of the key and SHA-256 of the signed header;
  * ``r1cs_info --config full1024 --json`` prints the JAX script's line.

Tolerance: exact equality."""

import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkemail_tpu.helpers.input_gen import InputGenArgs as JArgs
from zkemail_tpu.helpers.input_gen import generate_email_verifier_inputs as j_generate
from zkemail_tpu.models.email_verifier import EmailVerifierConfig as JConfig
from zkemail_tpu.models.email_verifier import build_email_verifier as j_build
from zkemail_tpu.models.input_bridge import prepare_inputs as j_prepare
from zkemail_tpu.scripts import r1cs_info as JRI
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.poseidon import poseidon_large
from zkemail_tpu_torch.helpers.dkim import verify_dkim_signature
from zkemail_tpu_torch.helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner
from zkemail_tpu_torch.models.email_verifier import EmailVerifierConfig
from zkemail_tpu_torch.models.input_bridge import prepare_inputs
from zkemail_tpu_torch.models.subcircuits import (
    CONFIGS, LONG_BODY_SLACK, bench_emails, build_bench_circuit, long_body_email)
from zkemail_tpu_torch.scripts import r1cs_info

torch.set_num_threads(2)

# (constraints, signals, publics) of both packages' builds
COUNTS = {"full1024": (2_190_813, 2_122_382, 3), "full4kb": (3_392_429, 3_300_638, 3)}
EMAILS = ("bench", "long")


def parity_run(name: str) -> SimpleNamespace:
    """Both packages' circuits of CONFIGS[name], both packages' inputs of a
    bench email and of a long-body email, and both witnesses of the
    long-body email at B = 1 (JAX on its host path, the port on the CPU)."""
    spec = CONFIGS[name]
    lengths = dict(max_headers_length=spec["max_headers_length"],
                   max_body_length=spec["max_body_length"])
    jcfg = JConfig(**lengths, ignore_body_hash_check=spec["ignore_body_hash_check"])
    cfg = EmailVerifierConfig(**lengths, ignore_body_hash_check=spec["ignore_body_hash_check"])
    jcc = j_build(jcfg).cs.compile()
    cc = build_bench_circuit(spec).compile()
    signer = LocalDKIMSigner(seed=10)
    emails = {"bench": bench_emails(signer, 1)[0],
              "long": long_body_email(signer, spec["max_body_length"], seed=1)}
    raws = {k: generate_email_verifier_inputs(e, signer.resolver(), InputGenArgs(**lengths))
            for k, e in emails.items()}
    j_raws = {k: j_generate(e, signer.resolver(), JArgs(**lengths)) for k, e in emails.items()}
    inputs = {k: prepare_inputs([r], cfg, device="cpu") for k, r in raws.items()}
    j_inputs = {k: j_prepare([r], jcfg) for k, r in j_raws.items()}
    jw = np.asarray(jcc.eval_witness(j_inputs["long"], 1))
    w = cc.eval_witness(inputs["long"], 1, device="cpu").numpy()
    return SimpleNamespace(name=name, spec=spec, jcc=jcc, cc=cc, signer=signer, emails=emails,
                           raws=raws, j_raws=j_raws, inputs=inputs, j_inputs=j_inputs,
                           jw=jw, w=w)


def check_r1cs(run) -> None:
    jcc, cc = run.jcc, run.cc
    assert (cc.n_constraints, cc.n_signals, cc.n_public) == COUNTS[run.name]
    assert (jcc.n_constraints, jcc.n_signals, jcc.n_public) == COUNTS[run.name]
    assert np.array_equal(jcc.perm, cc.perm)
    for m in "ABC":
        for x, y in zip(getattr(jcc, m), getattr(cc, m)):
            assert x.dtype == y.dtype and np.array_equal(x, y), m
    assert [s.name for s in jcc.steps] == [s.name for s in cc.steps]


def check_inputs(run, which: str) -> None:
    assert run.raws[which] == run.j_raws[which]
    got, want = run.inputs[which], run.j_inputs[which]
    assert set(got) == set(want)
    for k, x in got.items():
        assert x.device.type == "cpu" and x.dtype == torch.int32
        assert np.array_equal(x.numpy(), np.asarray(want[k])), k
    body_len = int(run.raws[which]["emailBodyLength"])
    if which == "long":  # the body's SHA-256 blocks hold data, not padding
        assert body_len >= run.spec["max_body_length"] - LONG_BODY_SLACK
    else:
        assert body_len == 64


def check_witness(run) -> None:
    assert run.w.shape == run.jw.shape == (22, run.cc.n_signals, 1)
    assert np.array_equal(run.w, run.jw)
    headers = verify_dkim_signature(run.emails["long"], run.signer.resolver()).headers
    digest = hashlib.sha256(headers).digest()
    pub = [int(v) for v in LB.limbs_to_ints(run.w[:, 1 : run.cc.n_public + 1, 0])]
    assert pub == [poseidon_large(run.signer.public_key[0], 121, 9),
                   int.from_bytes(digest[:16], "big"), int.from_bytes(digest[16:], "big")]


@pytest.fixture(scope="module")
def run():
    return parity_run("full1024")


def test_r1cs_equals_jax(run):
    check_r1cs(run)


@pytest.mark.parametrize("which", EMAILS)
def test_inputs_equal_jax(run, which):
    check_inputs(run, which)


def test_long_body_witness_equals_jax(run):
    check_witness(run)


def test_r1cs_info_full1024_equals_jax(capsys):
    outs = []
    for mod in (JRI, r1cs_info):
        mod.main(["--config", "full1024", "--json"])
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert outs[1]["n_constraints"] == COUNTS["full1024"][0]
