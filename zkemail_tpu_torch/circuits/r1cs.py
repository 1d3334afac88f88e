"""The minimal R1CS container that the port's setup and prover read.

A compiled circuit in the JAX package's layout (``CompiledCircuit`` of
``zkemail_tpu/circuits/builder.py``): signals permuted so that signal 0 is
the constant one and signals 1..n_public are the public inputs; each matrix
is a (rows, cols, coeffs) triple of equal-length arrays, rows and cols int,
coeffs Python ints in [0, r).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.field import R as P


@dataclass
class R1CS:
    name: str
    A: tuple
    B: tuple
    C: tuple
    n_constraints: int
    n_signals: int
    n_public: int
    # per-device tensors derived from the matrices (prover/groth16.py)
    cache: dict = field(default_factory=dict, repr=False, compare=False)

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


def matrix(rows, cols, coeffs) -> tuple:
    """A (rows, cols, coeffs) triple in the container's types, checked."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    coeffs = np.asarray(coeffs, dtype=object)
    if not (rows.shape == cols.shape == coeffs.shape) or rows.ndim != 1:
        raise ValueError("rows, cols and coeffs must be 1-D and of one length")
    return rows, cols, coeffs


def satisfied(cc, witness: torch.Tensor) -> torch.Tensor:
    """(B,) bool: whether A·w ∘ B·w = C·w holds on every constraint, for a
    witness batch (L, n_signals, B) of standard-form limbs, on its device.

    The matrices move to that device once (``prover/setup.py::matrix_pack``,
    cached on the circuit) and each product goes through the prover's
    ``qap_matvec`` (K1 on a CUDA tensor)."""
    from ..core import limbs as LB
    from ..prover.groth16 import qap_matvec
    from ..prover.setup import matrix_pack

    with torch.inference_mode():
        w_mont = LB.to_mont(LB.FR_SPEC, witness)
        aw, bw, cw = (qap_matvec(matrix_pack(cc, m, witness.device), w_mont, cc.n_constraints)
                      for m in "ABC")
        diff = LB.sub(LB.FR_SPEC, LB.mont_mul(LB.FR_SPEC, aw, bw), cw)
        return (diff == 0).all(dim=0).all(dim=0)
