"""The JAX package's frozen outputs (tests/fixtures/jax_reference/, written by
tests/make_jax_reference.py) still stand for the JAX package in this tree:
each file names the sha256 of every zkemail_tpu/**/*.py as it is here and
the installed jax version. Nothing is recomputed. The files together stay
under 2 MB."""

import pytest

import make_jax_reference as JR
from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)

REGENERATE = "regenerate with: JAX_PLATFORMS=cpu python tests/make_jax_reference.py"
NAMES = ["ec_scalar_mul_bits_g1", "msm_multi_n150", "msm_sorted_c13", "msm_sorted_pruned_c8",
         "poseidon_jax_b8", "toy_key_seed42", "toy_prove_seed42", "toy_prove_seed7",
         "zkeytoy_key_seed9"]


def test_every_fixture_is_listed():
    assert JR.names() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_fixture_names_this_tree(name):
    _, meta = JR.read(name)
    tree = JR.source_hashes()
    changed = sorted(p for p in tree.keys() | meta["sources"].keys()
                     if tree.get(p) != meta["sources"].get(p))
    assert not changed, f"{name}: zkemail_tpu/ changed since it was made ({changed}); {REGENERATE}"
    assert meta["jax"] == JR.jax_version(), (
        f"{name}: made with jax {meta['jax']}, jax {JR.jax_version()} installed; {REGENERATE}")


def test_fixtures_under_2_mb():
    assert sum(p.stat().st_size for p in JR.FIXTURES.glob("*.npz")) < 2 << 20
