"""The CUDA kernels K1-K3 against their plain PyTorch versions, exactly.

These need a CUDA device and nvcc (the kernels are built at first use), so
they are marked `cuda` and skip on a machine without a card. On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from zkemail_tpu_torch.core import field as F
from zkemail_tpu_torch.ops import field_kernels as FK

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(dev, n, gen):
    x = torch.randint(0, 1 << F.LIMB_BITS, (F.LIMBS, n), dtype=torch.int32,
                      device=dev, generator=gen)
    x[-1] %= 3  # below both moduli, whose top limb is 3
    return x


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_mont_mul_kernel_equals_plain(dev, field):
    gen = torch.Generator(device=dev).manual_seed(1)
    a, b = _rand(dev, 4099, gen), _rand(dev, 4099, gen)
    before = FK.LAUNCHES["mont_mul"]
    out = FK.mont_mul_flat(field, a, b)
    assert FK.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(out, FK.mont_mul_plain(field, a, b))


def _components(pt: dict, group: str) -> list:
    return [pt[k] for k in "xyz"] if group == "g1" else [c for k in "xyz" for c in pt[k]]


def _curve_operands(dev, group, n, gen):
    """Random coordinates p, q and neg (set on lanes i % 3 == 0), with the
    lane i % 6 == 0 adding the identity, 1 adding to the identity, 2 adding
    p = (0, ...) and q with every coordinate p - 1, 3 P + P and 4 P + (-P)."""
    def coord():
        return _rand(dev, n, gen) if group == "g1" else (_rand(dev, n, gen), _rand(dev, n, gen))

    p = {k: coord() for k in "xyz"}
    q = {k: coord() for k in "xyz"}
    i = torch.arange(n, device=dev)
    role = i % 6
    col = lambda v: torch.tensor(F.to_limbs(v), dtype=torch.int32, device=dev)[:, None]
    one, p_minus_1 = col(F.FQ.to_mont(1)), col(F.Q - 1)
    ident = [0, one, 0] if group == "g1" else [0, 0, one, 0, 0, 0]
    pc, qc = _components(p, group), _components(q, group)
    for c, v in zip(qc, ident):
        c[:, role == 0] = v
    for c, v in zip(pc, ident):
        c[:, role == 1] = v
    for c in pc[: len(pc) // 3]:
        c[:, role == 2] = 0
    for c in qc:
        c[:, role == 2] = p_minus_1
    for a, b in zip(pc, qc):
        b[:, (role == 3) | (role == 4)] = a[:, (role == 3) | (role == 4)]
    neg = ((i % 3 == 0) & (role != 3)) | (role == 4)
    return p, q, neg.to(torch.int32)


@pytest.mark.parametrize("n", [1, 2, 64, 1027])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ec_add_kernels_equal_plain(dev, group, n):
    gen = torch.Generator(device=dev).manual_seed(2)
    p, q, neg = _curve_operands(dev, group, n, gen)
    kern, plain = {"g1": (FK.ec_add_g1_flat, FK.ec_add_g1_plain),
                   "g2": (FK.ec_add_g2_flat, FK.ec_add_g2_plain)}[group]
    name = f"ec_add_{group}"
    before = FK.LAUNCHES[name]
    out, ref = kern(p, q, neg), plain(p, q, neg)
    assert FK.LAUNCHES[name] == before + 1
    for a, b in zip(_components(out, group), _components(ref, group)):
        assert torch.equal(a, b)


def test_witness_on_card_equals_cpu(dev):
    """A small circuit of the gadgets with witness steps of their own (bits,
    is_zero's inversion, full-field products, Poseidon, SHA-256): its
    witness on the card, K1 included, equals the CPU's limb for limb."""
    import numpy as np

    from zkemail_tpu_torch.circuits.builder import ConstraintSystem
    from zkemail_tpu_torch.circuits.gadgets import basic
    from zkemail_tpu_torch.circuits.gadgets.poseidon_gadget import poseidon_hash
    from zkemail_tpu_torch.circuits.gadgets.sha_wrappers import sha256_bytes
    from zkemail_tpu_torch.core import limbs as LB
    from zkemail_tpu_torch.helpers.sha_utils import sha256_pad

    cs = ConstraintSystem("card")
    x = cs.add_input("x", (3,))
    f = cs.add_input("f", (3,), dtype="fr")
    data = cs.add_input("data", (64,))
    n = cs.add_input("len", ())
    basic.num2bits(cs, x, 20)
    basic.is_zero(cs, x)
    poseidon_hash(cs, cs.mul(f, x))
    sha256_bytes(cs, data, n)
    cc = cs.compile()
    rng = np.random.default_rng(3)
    msgs = [rng.bytes(20), rng.bytes(40)]
    padded = [sha256_pad(m, 64) for m in msgs]
    arrs = {
        "x": np.array([[0, 7], [1 << 19, 5], [3, 0]], dtype=np.int32),
        "f": LB.ints_to_limbs([[int(rng.integers(1, 1 << 62)) << 180 for _ in range(2)]
                               for _ in range(3)]),
        "data": np.stack([np.frombuffer(p, dtype=np.uint8) for p, _ in padded], 1).astype(np.int32),
        "len": np.array([n for _, n in padded], dtype=np.int32),
    }
    before = FK.LAUNCHES["mont_mul"]
    w_card = cc.eval_witness({k: torch.as_tensor(v, device=dev) for k, v in arrs.items()}, 2)
    assert FK.LAUNCHES["mont_mul"] > before
    w_cpu = cc.eval_witness({k: torch.as_tensor(v) for k, v in arrs.items()}, 2, device="cpu")
    assert torch.equal(w_card.cpu(), w_cpu)


def test_zkey_and_chunks_on_card_equal_cpu(dev, tmp_path):
    """The .zkey conversions (affine form, the 2^256 / 2^264 rescaling, the
    byte repacking, the coefficient section) give the same bytes and the
    same tables on the card as on the CPU, and a chunked export of a card
    key loads onto the CPU to equal limbs. The key is a setup on the card
    of a 2^10 synthetic circuit, its points projective with z != 1."""
    from zkemail_tpu_torch.prover import artifacts as TA
    from zkemail_tpu_torch.prover import zkey as TZ
    from zkemail_tpu_torch.prover.setup import groth16_setup
    from zkemail_tpu_torch.scripts.synthetic_r1cs import make_circuit

    circ = make_circuit(1000, 960, seed=1)
    pk = groth16_setup(circ.r1cs, seed=3, device=dev)

    def tables(key):
        return [c.cpu() for q in TA.QUERIES for v in getattr(key, q).values()
                for c in (v if isinstance(v, tuple) else (v,))]

    before = FK.LAUNCHES["mont_mul"]
    blob = TZ.write_zkey(pk, circ.r1cs)
    assert FK.LAUNCHES["mont_mul"] > before
    pk_card, coeffs_card = TZ.read_zkey(blob, device=dev)
    pk_cpu, coeffs_cpu = TZ.read_zkey(blob, device="cpu")
    assert pk_card.device.type == "cuda" and pk_card.n_constraints == circ.r1cs.n_constraints
    assert all(torch.equal(a, b) for a, b in zip(tables(pk_card), tables(pk_cpu)))
    for m in "AB":
        for a, b in zip(coeffs_card[m], coeffs_cpu[m]):
            assert list(a) == list(b)
    assert TZ.write_zkey(pk_cpu, circ.r1cs) == blob
    TA.export_chunked(pk, str(tmp_path), name="k")
    loaded = TA.load_chunked(str(tmp_path), name="k", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tables(loaded), tables(pk)))


def test_second_card_proves_as_the_first(dev):
    """A key set up and proved on cuda:1, from a process whose current card
    is cuda:0, gives the proofs of cuda:0: every kernel launches on its
    operands' card, and the devices compare equal however they are named."""
    import random

    from zkemail_tpu_torch.prover.groth16 import prove_batch
    from zkemail_tpu_torch.prover.setup import groth16_setup
    from zkemail_tpu_torch.scripts.synthetic_r1cs import make_circuit

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    circ = make_circuit(200, 180, seed=1)
    w = circ.witness(2, seed=2)
    got = {}
    for card in ("cuda:0", "cuda:1"):
        assert torch.cuda.current_device() == 0
        pk = groth16_setup(circ.r1cs, seed=3, device=card)
        assert pk.device == torch.device(card)
        before = dict(FK.LAUNCHES)
        proofs = prove_batch(pk, circ.r1cs, w, rng=random.Random(4), device=card)
        assert all(FK.LAUNCHES[k] > before[k] for k in FK.LAUNCHES)
        got[card] = [(p.a, p.b, p.c, tuple(pub)) for p, pub in proofs]
    assert got["cuda:1"] == got["cuda:0"]
    # an unindexed "cuda" names the current card, the key's device here
    pk = groth16_setup(circ.r1cs, seed=3, device="cuda:0")
    assert prove_batch(pk, circ.r1cs, w, rng=random.Random(4))[0][0].a == got["cuda:0"][0][0]


def test_pubkey_hashes_on_card_equal_plain_and_reference(dev, monkeypatch):
    """The registry's batched Poseidon at B = 4,096 on the card: 274 K1
    launches (272 rounds' products and two conversions), equal to the same
    function with K1's plain version on the card, and to poseidon_large."""
    import random

    from zkemail_tpu_torch.core import limbs as LB
    from zkemail_tpu_torch.core.poseidon import poseidon_large
    from zkemail_tpu_torch.core.poseidon_torch import pubkey_hashes

    rng = random.Random(9)
    moduli = [rng.getrandbits(2048) | (1 << 2047) | 1 for _ in range(4096)]
    before = FK.LAUNCHES["mont_mul"]
    card = pubkey_hashes(moduli, device=dev)
    assert FK.LAUNCHES["mont_mul"] - before == 274
    monkeypatch.setattr(FK, "mont_mul_flat", lambda field, a, b: FK.mont_mul_plain(field, a, b))
    plain = pubkey_hashes(moduli, device=dev)
    assert torch.equal(card, plain)
    got = [int(v) for v in LB.limbs_to_ints(card[:, :16])]
    assert got == [poseidon_large(m, 121, 9) for m in moduli[:16]]


def test_tool_scripts_run_on_card(capsys):
    """msm_stress (both algorithms) and prim_bench run on the card by
    default and print their JSON lines."""
    import json

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zkemail_tpu_torch.scripts import msm_stress, prim_bench

    for algo in ("sort", "bucket"):
        line = msm_stress.main(["--n", "4096", "--batch", "2", "--algo", algo, "--reps", "1"])
        assert line["metric"] == "msm_stress_s" and line["value"] > 0
    out = prim_bench.main(["--n", "65536", "--reps", "2"])
    assert len(out) == 14 and all(v["s"] > 0 for v in out.values())
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out


def test_full1024_proves_on_card(dev):
    """bench.py's full1024 (header 1024, body 1536, 2^22 domain) at B = 2 on
    the card: two bench emails' witness satisfies the R1CS, setup and
    prove_batch launch K1, K2 and K3, and both proofs verify under the
    native verifier and the pairing oracle, a tampered public refused."""
    import random

    from zkemail_tpu_torch.circuits.r1cs import satisfied
    from zkemail_tpu_torch.helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
    from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner
    from zkemail_tpu_torch.models.email_verifier import EmailVerifierConfig
    from zkemail_tpu_torch.models.input_bridge import prepare_inputs
    from zkemail_tpu_torch.models.subcircuits import CONFIGS, bench_emails, build_bench_circuit
    from zkemail_tpu_torch.native import verifier as native
    from zkemail_tpu_torch.prover.containers import verify
    from zkemail_tpu_torch.prover.groth16 import prove_batch
    from zkemail_tpu_torch.prover.setup import groth16_setup

    spec = CONFIGS["full1024"]
    lengths = dict(max_headers_length=spec["max_headers_length"],
                   max_body_length=spec["max_body_length"])
    cc = build_bench_circuit(spec).compile()
    signer = LocalDKIMSigner(seed=12)
    raws = [generate_email_verifier_inputs(e, signer.resolver(), InputGenArgs(**lengths))
            for e in bench_emails(signer, 2)]
    w = cc.eval_witness(prepare_inputs(raws, EmailVerifierConfig(**lengths), device=dev), 2,
                        device=dev)
    assert bool(satisfied(cc, w).all())
    pk = groth16_setup(cc, seed=7, device=dev)
    assert pk.domain_log2 == 22
    before = dict(FK.LAUNCHES)
    proofs = prove_batch(pk, cc, w, rng=random.Random(4), device=dev)
    assert all(FK.LAUNCHES[k] > before[k] for k in FK.LAUNCHES)
    for i, (proof, publics) in enumerate(proofs):
        bad = [(publics[0] + 1) % F.R] + publics[1:]
        assert native.verify(pk.vk, proof, publics) and not native.verify(pk.vk, proof, bad)
        if i == 0:
            assert verify(pk.vk, proof, publics) and not verify(pk.vk, proof, bad)
