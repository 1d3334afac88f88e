"""The port's arkworks serialization, native C++ Groth16 verifier and its
codegen CLI against the JAX package's, on a toy proof from the port's own
setup and prove on the CPU.

The JAX verifier runs from a private build of its source (the JAX module
builds beside its source on first use, which other test processes may do
at the same time). Tolerance: exact equality of bytes, text, points and
verdicts."""

import ctypes
import json
import random
import subprocess

import pytest
import torch

from zkemail_tpu.native import codegen as JCG
from zkemail_tpu.native import verifier as JNV
from zkemail_tpu.prover.containers import VerifyingKey as JVK
from zkemail_tpu.utils import ark_serialize as JA
from zkemail_tpu_torch.circuits.builder import ConstraintSystem
from zkemail_tpu_torch.core.curve import G1
from zkemail_tpu_torch.native import codegen as TCG
from zkemail_tpu_torch.native import verifier as TNV
from zkemail_tpu_torch.prover.containers import Proof, VerifyingKey, publics_to_snarkjs, verify
from zkemail_tpu_torch.prover.groth16 import prove_batch
from zkemail_tpu_torch.prover.setup import groth16_setup
from zkemail_tpu_torch.utils import ark_serialize as TA

torch.set_num_threads(1)


def _g1(p):
    return (True,) if p.inf else (False, int(p.x), int(p.y))


def _g2(p):
    return (True,) if p.inf else (False, int(p.x.c0), int(p.x.c1), int(p.y.c0), int(p.y.c1))


def _vk_points(vk):
    return ([_g1(vk.alpha_g1)] + [_g2(getattr(vk, n)) for n in ("beta_g2", "gamma_g2",
                                                                "delta_g2")]
            + [_g1(p) for p in vk.ic])


@pytest.fixture(scope="module")
def toy():
    """x (private), y = x^2 + x + 3 (public): the port's setup and one proof."""
    cs = ConstraintSystem("nativetoy")
    x = cs.add_input("x", ())
    cs.mark_public(cs.define(cs.mul(x, x) + x + 3))
    cc = cs.compile()
    pk = groth16_setup(cc, seed=11, device="cpu")
    w = cc.eval_witness({"x": torch.tensor([5], dtype=torch.int32)}, 1, device="cpu")
    (proof, publics), = prove_batch(pk, cc, w, rng=random.Random(3), device="cpu")
    assert publics == [33] and verify(pk.vk, proof, publics)
    return pk.vk, proof, publics


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's verifier module over a private build of its source."""
    so = tmp_path_factory.mktemp("jaxnative") / "libgroth16.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", str(JNV._SRC), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.groth16_verify.restype = ctypes.c_int
    lib.groth16_verify.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int]
    saved, JNV._lib = JNV._lib, lib
    yield JNV
    JNV._lib = saved


def test_ark_encodings_equal_jax(toy):
    vk, proof, publics = toy
    blob = TA.encode_vkey(vk)
    assert blob == JA.encode_vkey(vk)
    assert TA.encode_proof(proof) == JA.encode_proof(proof)
    assert TA.encode_publics(publics + [2**255 + 7]) == JA.encode_publics(publics + [2**255 + 7])
    for p in [proof.a, proof.c, G1.identity(), proof.a.neg()] + vk.ic:
        assert TA.encode_g1(p) == JA.encode_g1(p)
        assert _g1(TA.decode_g1(TA.encode_g1(p))) == _g1(p)
    for p in (proof.b, proof.b.neg(), vk.beta_g2, vk.delta_g2, type(proof.b).identity()):
        assert TA.encode_g2(p) == JA.encode_g2(p)
        assert _g2(TA.decode_g2(TA.encode_g2(p))) == _g2(p)
    back = VerifyingKey.from_ark_bytes(blob)
    assert _vk_points(back) == _vk_points(vk) == _vk_points(JVK.from_ark_bytes(blob))
    assert TA.decode_fr(TA.encode_fr(publics[0])) == publics[0]


def test_native_verify_equals_jax(toy, jax_native):
    vk, proof, publics = toy
    bumped = Proof(proof.a.add(G1.generator()), proof.b, proof.c)
    cases = [(proof, publics), (bumped, publics), (proof, [publics[0] + 1]),
             (Proof(proof.c, proof.b, proof.a), publics)]
    got = [TNV.verify(vk, p, pub) for p, pub in cases]
    assert got == [jax_native.verify(vk, p, pub) for p, pub in cases]
    assert got == [verify(vk, p, pub) for p, pub in cases] == [True, False, False, False]
    with pytest.raises(ValueError):
        TNV.verify(vk, proof, publics + [1])
    assert TNV.build().parent.name == "_build"


def test_codegen_equals_jax_and_binary_exit_codes(toy, tmp_path, capsys):
    vk, proof, publics = toy
    (tmp_path / "vkey.json").write_text(json.dumps(vk.to_snarkjs()))
    (tmp_path / "proof.json").write_text(json.dumps(proof.to_snarkjs()))
    (tmp_path / "public.json").write_text(json.dumps(publics_to_snarkjs(publics)))
    outs = {}
    for cg, name in ((JCG, "jax"), (TCG, "port")):
        cg.main(["generate-verifier", "-v", str(tmp_path / "vkey.json"),
                 "-o", str(tmp_path / f"{name}.cpp")])
        cg.main(["generate-verifier-arguments", "-p", str(tmp_path / "proof.json"),
                 "-i", str(tmp_path / "public.json"), "--out-dir", str(tmp_path / name)])
        outs[name] = capsys.readouterr().out.replace(f"{name}.cpp", "verifier.cpp")
    assert outs["port"] == outs["jax"]  # "wrote ...", PROOF: [...], PUBLIC_INPUTS: [...]
    jax_text = (tmp_path / "jax.cpp").read_text()
    port_text = (tmp_path / "port.cpp").read_text()
    # the same text, but for the generator's module name and the file name
    assert port_text.replace("zkemail_tpu_torch.native", "zkemail_tpu.native").replace(
        "port.cpp", "jax.cpp") == jax_text
    for f in ("proof.bin", "publics.bin", "proof.flat.bin", "publics.flat.bin"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()

    exe = tmp_path / "verifier"
    subprocess.run(["g++", "-O2", "-std=c++17", str(tmp_path / "port.cpp"), "-o", str(exe)],
                   check=True, capture_output=True)
    args = [str(tmp_path / "port" / "proof.flat.bin"), str(tmp_path / "port" / "publics.flat.bin")]
    ok = subprocess.run([str(exe), *args], capture_output=True, text=True)
    assert ok.returncode == 0 and ok.stdout.strip() == "OK"
    bad = bytearray((tmp_path / "port" / "proof.flat.bin").read_bytes())
    bad[5] ^= 1
    (tmp_path / "bad.bin").write_bytes(bytes(bad))
    tampered = subprocess.run([str(exe), str(tmp_path / "bad.bin"), args[1]],
                              capture_output=True, text=True)
    assert tampered.returncode == 1 and tampered.stdout.strip() == "INVALID"
    assert subprocess.run([str(exe)], capture_output=True).returncode == 2
