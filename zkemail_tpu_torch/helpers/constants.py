"""Shared constants — must agree across host pipeline, circuits, and contracts.

Mirrors zk-email-verify packages/helpers/src/constants.ts:1-7 and
packages/circuits/utils/constants.circom:4-15.
"""

# BN254 scalar field modulus (circuit field)
CIRCOM_FIELD_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

MAX_HEADER_PADDED_BYTES = 1024
MAX_BODY_PADDED_BYTES = 1536

# RSA bigint limb shape: 121 bits x 17 limbs (n*k > 2048, n < 127)
CIRCOM_BIGINT_N = 121
CIRCOM_BIGINT_K = 17

# byte packing into field elements
MAX_BYTES_IN_FIELD = 31
