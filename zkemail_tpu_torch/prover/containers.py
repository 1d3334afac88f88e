"""Groth16 proof/key containers + the verification equation (oracle path).

A self-contained checker in place of snarkjs' `groth16.verify`, used as the
oracle for the prover. A copy of the JAX package's module, so that the port
imports nothing of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.curve import G1, G2, multi_pairing_is_one
from ..core.field import R


@dataclass
class Proof:
    a: G1
    b: G2
    c: G1

    @staticmethod
    def from_snarkjs(obj: dict) -> "Proof":
        """Parse snarkjs proof.json (affine decimal strings, projective z=1)."""
        from ..core.towers import Fq2

        pa = G1(int(obj["pi_a"][0]), int(obj["pi_a"][1]))
        pb = G2(
            Fq2(int(obj["pi_b"][0][0]), int(obj["pi_b"][0][1])),
            Fq2(int(obj["pi_b"][1][0]), int(obj["pi_b"][1][1])),
        )
        pc = G1(int(obj["pi_c"][0]), int(obj["pi_c"][1]))
        return Proof(pa, pb, pc)

    def to_snarkjs(self) -> dict:
        """Emit snarkjs proof.json structure (decimal strings, projective
        z=1 third coordinate), consumable by snarkjs.groth16.verify and the
        upstream rust verifier."""
        return {
            "pi_a": [str(self.a.x), str(self.a.y), "1"],
            "pi_b": [
                [str(self.b.x.c0), str(self.b.x.c1)],
                [str(self.b.y.c0), str(self.b.y.c1)],
                ["1", "0"],
            ],
            "pi_c": [str(self.c.x), str(self.c.y), "1"],
            "protocol": "groth16",
            "curve": "bn128",
        }


@dataclass
class VerifyingKey:
    alpha_g1: G1
    beta_g2: G2
    gamma_g2: G2
    delta_g2: G2
    ic: list = field(default_factory=list)

    @staticmethod
    def from_ark_bytes(data: bytes) -> "VerifyingKey":
        """Decode an arkworks compressed VerifyingKey<Bn254>."""
        from ..utils.ark_serialize import decode_vkey

        return VerifyingKey(**decode_vkey(data))

    @staticmethod
    def from_snarkjs(obj: dict) -> "VerifyingKey":
        """Parse a snarkjs vkey.json (decimal-string affine coordinates),
        mirroring GrothBnVkey::from_json (verifier_utils.rs:93-153)."""
        from ..core.towers import Fq2

        def g1(c):
            return G1(int(c[0]), int(c[1]))

        def g2(c):
            return G2(Fq2(int(c[0][0]), int(c[0][1])), Fq2(int(c[1][0]), int(c[1][1])))

        return VerifyingKey(
            alpha_g1=g1(obj["vk_alpha_1"]),
            beta_g2=g2(obj["vk_beta_2"]),
            gamma_g2=g2(obj["vk_gamma_2"]),
            delta_g2=g2(obj["vk_delta_2"]),
            ic=[g1(c) for c in obj["IC"]],
        )

    def to_snarkjs(self) -> dict:
        """Emit snarkjs vkey.json structure for our own CRS, so external
        tooling (snarkjs verify, rust-verifier generate-verifier, this repo's
        codegen CLI) can consume these setups."""

        def g1(p: G1):
            return [str(p.x), str(p.y), "1"]

        def g2(p: G2):
            return [
                [str(p.x.c0), str(p.x.c1)],
                [str(p.y.c0), str(p.y.c1)],
                ["1", "0"],
            ]

        return {
            "protocol": "groth16",
            "curve": "bn128",
            "nPublic": len(self.ic) - 1,
            "vk_alpha_1": g1(self.alpha_g1),
            "vk_beta_2": g2(self.beta_g2),
            "vk_gamma_2": g2(self.gamma_g2),
            "vk_delta_2": g2(self.delta_g2),
            "IC": [g1(p) for p in self.ic],
        }


def publics_to_snarkjs(public_inputs: list[int]) -> list[str]:
    """snarkjs public.json: decimal strings."""
    return [str(int(x) % R) for x in public_inputs]


def verify(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    """e(A,B) == e(alpha,beta) * e(L_pub, gamma) * e(C, delta)."""
    if len(public_inputs) + 1 != len(vk.ic):
        raise ValueError("public input count mismatch")
    if not (proof.a.on_curve() and proof.b.on_curve() and proof.c.on_curve()):
        return False
    acc = vk.ic[0]
    for x, pt in zip(public_inputs, vk.ic[1:]):
        acc = acc.add(pt.mul(x % R))
    return multi_pairing_is_one(
        [
            (proof.a.neg(), proof.b),
            (vk.alpha_g1, vk.beta_g2),
            (acc, vk.gamma_g2),
            (proof.c, vk.delta_g2),
        ]
    )
