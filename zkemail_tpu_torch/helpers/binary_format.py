"""Byte/bigint/limb conversions shared between host pipeline and circuits.

Mirrors the semantics of zk-email-verify packages/helpers/src/binary-format.ts
(toCircomBigIntBytes:81, bigIntToChunkedBytes:71, packedNBytesToString:182).
"""

from __future__ import annotations

from .constants import CIRCOM_BIGINT_K, CIRCOM_BIGINT_N, MAX_BYTES_IN_FIELD


def big_int_to_chunks(x: int, chunk_bits: int, num_chunks: int) -> list[int]:
    mask = (1 << chunk_bits) - 1
    out = [(x >> (i * chunk_bits)) & mask for i in range(num_chunks)]
    if x >> (chunk_bits * num_chunks):
        raise ValueError("value too large for chunk layout")
    return out


def chunks_to_big_int(chunks: list[int], chunk_bits: int) -> int:
    v = 0
    for i, c in enumerate(chunks):
        v |= int(c) << (i * chunk_bits)
    return v


def to_circom_bigint(x: int) -> list[int]:
    """121-bit x 17 limbs, LSB first (toCircomBigIntBytes)."""
    return big_int_to_chunks(x, CIRCOM_BIGINT_N, CIRCOM_BIGINT_K)


def pack_bytes_to_fields(data: bytes, max_bytes: int | None = None) -> list[int]:
    """Pack bytes into field elements, 31 bytes per field, little-endian —
    circuits/utils/bytes.circom:28 PackBytes semantics."""
    if max_bytes is not None:
        data = data[:max_bytes] + b"\x00" * max(0, max_bytes - len(data))
    out = []
    for i in range(0, len(data), MAX_BYTES_IN_FIELD):
        chunk = data[i : i + MAX_BYTES_IN_FIELD]
        out.append(int.from_bytes(chunk, "little"))
    return out


def unpack_fields_to_bytes(fields: list[int], total_bytes: int) -> bytes:
    out = bytearray()
    for f in fields:
        out += int(f).to_bytes(MAX_BYTES_IN_FIELD, "little")
    return bytes(out[:total_bytes])


def packed_to_string(fields: list[int]) -> str:
    """Decode packed fields to a string, stripping trailing NULs
    (packedNBytesToString)."""
    raw = unpack_fields_to_bytes(fields, len(fields) * MAX_BYTES_IN_FIELD)
    return raw.rstrip(b"\x00").decode("utf-8", errors="replace")


def bytes_to_int_be(b: bytes) -> int:
    return int.from_bytes(b, "big")


# --------------------------------------------------------------------------
# Legacy ECDSA circuit input glue (chunked-zkey.ts:107-147)
# --------------------------------------------------------------------------

def pubkey_to_xy_arrays(pk_hex: str) -> list[list[str]]:
    """Uncompressed secp256k1 pubkey hex ("0x04" + X + Y) -> [XArr, YArr] of
    4x64-bit decimal-string limbs (chunked-zkey.ts pubkeyToXYArrays:123)."""
    x = int(pk_hex[4 : 4 + 64], 16)
    y = int(pk_hex[68 : 68 + 64], 16)
    return [
        [str(v) for v in big_int_to_chunks(x, 64, 4)],
        [str(v) for v in big_int_to_chunks(y, 64, 4)],
    ]


def sig_to_rs_arrays(sig_hex: str) -> list[list[str]]:
    """0x-prefixed 65-byte signature hex -> [rArr, sArr] of 4x64-bit limbs
    (chunked-zkey.ts sigToRSArrays:131)."""
    r = int(sig_hex[2 : 2 + 64], 16)
    s = int(sig_hex[66 : 66 + 64], 16)
    return [
        [str(v) for v in big_int_to_chunks(r, 64, 4)],
        [str(v) for v in big_int_to_chunks(s, 64, 4)],
    ]


def build_ecdsa_input(pubkey_hex: str, msghash: str, sig_hex: str) -> dict:
    """Witness inputs for the legacy ECDSA ownership circuits
    (chunked-zkey.ts buildInput:138): r/s/msghash/pubkey as 4x64-bit limbs."""
    r, s = sig_to_rs_arrays(sig_hex)
    return {
        "r": r,
        "s": s,
        "msghash": big_int_to_chunks(int(msghash, 0), 64, 4),
        "pubkey": pubkey_to_xy_arrays(pubkey_hex),
    }
