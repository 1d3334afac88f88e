"""The port at bench.py's full4kb config against the JAX package, on the CPU.

full4kb is the EmailVerifier at header 1024 and body 4096 bytes with the
body-hash check (BASELINE.md's "full EmailVerifier (4KB body)"), the
largest circuit of bench.py, on a 2^22 domain. The checks are those of
``tests/test_torch_full1024.py`` (its ``parity_run``): the R1CS entry for
entry, both packages' inputs of a bench email and of an email whose body
fills most of the 4 KB, and the port's CPU witness of that email at B = 1
limb for limb against the JAX ``eval_witness``, with the host's publics.
Tolerance: exact equality."""

import pytest

from test_torch_full1024 import EMAILS, check_inputs, check_r1cs, check_witness, parity_run


@pytest.fixture(scope="module")
def run():
    return parity_run("full4kb")


def test_r1cs_equals_jax(run):
    check_r1cs(run)


@pytest.mark.parametrize("which", EMAILS)
def test_inputs_equal_jax(run, which):
    check_inputs(run, which)


def test_long_body_witness_equals_jax(run):
    check_witness(run)
