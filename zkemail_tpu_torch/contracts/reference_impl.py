"""Python mirrors of the Solidity contract logic, for EVM-free testing.

Parity: each function matches the corresponding library in
zkemail_tpu/contracts/*.sol (and the reference
packages/contracts/utils/{CircomUtils,NoirUtils,StringUtils}.sol,
UserOverrideableDKIMRegistry.sol).  The packing mirrors are cross-checked
against helpers.binary_format in tests — the circuit <-> contract layout
agreement the reference relies on (CircomUtils packing == circuit PackBytes).

A copy of ``zkemail_tpu/contracts/reference_impl.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

BYTES_PER_FIELD = 31


# --------------------------------------------------------------- CircomUtils
def circom_pack_fields(data: bytes) -> list[int]:
    n = (len(data) + BYTES_PER_FIELD - 1) // BYTES_PER_FIELD
    out = []
    for k in range(n):
        acc = 0
        for j in range(BYTES_PER_FIELD):
            i = k * BYTES_PER_FIELD + j
            if i >= len(data):
                break
            acc |= data[i] << (8 * j)
        out.append(acc)
    return out


def circom_unpack_fields(fields: list[int], byte_length: int) -> bytes:
    out = bytearray(byte_length)
    for i in range(byte_length):
        k, j = divmod(i, BYTES_PER_FIELD)
        out[i] = (fields[k] >> (8 * j)) & 0xFF
    return bytes(out)


def circom_pack_fields_padded(data: bytes, padded_size: int) -> list[int]:
    """Reference-ABI form (CircomUtils.packFieldsArray(bytes,uint256)):
    zero-pads out to padded_size bytes; reverts InvalidDataLength if longer."""
    if len(data) > padded_size:
        raise ValueError("InvalidDataLength")
    n = (padded_size + BYTES_PER_FIELD - 1) // BYTES_PER_FIELD
    out = []
    for k in range(n):
        acc = 0
        for j in range(BYTES_PER_FIELD):
            i = k * BYTES_PER_FIELD + j
            if i >= padded_size:
                break
            if i < len(data):
                acc |= data[i] << (8 * j)
        out.append(acc)
    return out


def circom_unpack_fields_padded(fields: list[int], padded_size: int) -> bytes:
    """Reference-ABI unpack: read ceil(padded_size/31) fields, trim trailing
    zero bytes. An undersized fields array raises (array OOB panic parity)."""
    n = (padded_size + BYTES_PER_FIELD - 1) // BYTES_PER_FIELD
    raw = bytearray()
    for i in range(n):
        f = fields[i]  # IndexError == solidity array-OOB panic
        for _ in range(BYTES_PER_FIELD):
            if len(raw) >= padded_size:
                break
            raw.append(f & 0xFF)
            f >>= 8
    actual = 0
    for i, b in enumerate(raw):
        if b:
            actual = i + 1
    return bytes(raw[:actual])


def circom_pack_bool(value: bool) -> list[int]:
    return [1 if value else 0]


def circom_unpack_bool(fields: list[int]) -> bool:
    return fields[0] == 1


# ----------------------------------------------------------------- NoirUtils
def noir_pack_bounded_vec_u8(data: bytes, num_fields: int) -> list[int]:
    """BoundedVec<u8>: num_fields INCLUDES the trailing length slot
    (reference NoirUtils.packBoundedVecU8 — InvalidLength when
    len(data) >= num_fields)."""
    if len(data) >= num_fields:
        raise ValueError("InvalidLength")
    out = [0] * num_fields
    for i, b in enumerate(data):
        out[i] = b
    out[num_fields - 1] = len(data)
    return out


def noir_unpack_bounded_vec_u8(fields: list[int]) -> bytes:
    """Inverse: length from the final field, one LSB byte per field."""
    length = fields[-1]
    return bytes(fields[i] & 0xFF for i in range(length))


def noir_pack_fields(data: bytes, num_fields: int) -> list[int]:
    """31-byte LE fields (reference NoirUtils.packFieldsArray)."""
    if len(data) > num_fields * BYTES_PER_FIELD:
        raise ValueError("InvalidLength")
    out = []
    for i in range(num_fields):
        start = i * BYTES_PER_FIELD
        f = 0
        for j in range(BYTES_PER_FIELD):
            if start + j >= len(data):
                break
            f |= data[start + j] << (8 * j)
        out.append(f)
    return out


def noir_unpack_fields(fields: list[int]) -> bytes:
    """Inverse of noir_pack_fields, trimming trailing zero bytes."""
    raw = bytearray()
    for f in fields:
        for _ in range(BYTES_PER_FIELD):
            raw.append(f & 0xFF)
            f >>= 8
    actual = 0
    for i, b in enumerate(raw):
        if b:
            actual = i + 1
    return bytes(raw[:actual])


# --------------------------------------------------------------- StringUtils
def convert_packed_bytes_to_string(packed: list[int], pack_size: int = BYTES_PER_FIELD) -> str:
    seen_null = False
    out = bytearray()
    for p in packed:
        for j in range(pack_size):
            b = (p >> (8 * j)) & 0xFF
            if b == 0:
                seen_null = True
            else:
                if seen_null:
                    raise ValueError("non-zero byte after null")
                out.append(b)
    return out.decode("utf-8")


def get_domain_from_email(email: str) -> str:
    if "@" not in email:
        raise ValueError("no @ in email")
    return email.rsplit("@", 1)[1]


# --------------------------------------------- ECDSAOwnedDKIMRegistry model
@dataclass
class ECDSAOwnedRegistryModel:
    """Executable mirror of ECDSAOwnedDKIMRegistry.sol: set/revoke gated by a
    SET:/REVOKE: message ECDSA-signed by `signer` (reference :58-61,99-106).
    Revert strings match the reference contract verbatim (differential
    harness tests/test_contracts_differential.py); revocation is GLOBAL and
    permanent per key hash (reference DKIMRegistry
    revokedDKIMPublicKeyHashes)."""

    signer: str  # ethereum address (lowercase hex)
    keys: dict = field(default_factory=dict)  # (domHash, key) -> bool
    revoked: dict = field(default_factory=dict)  # key -> True (global)

    SET_PREFIX = "SET:"
    REVOKE_PREFIX = "REVOKE:"

    def compute_signed_msg(self, prefix: str, domain_name: str, key: int) -> str:
        return f"{prefix}domain={domain_name};public_key_hash={to_hex_string(key)};"

    def _recover(self, message: str, signature: bytes) -> str | None:
        from ..utils import secp256k1 as EC

        digest = eth_signed_digest(message.encode())
        _require(len(signature) == 65, "invalid signature length")
        r = int.from_bytes(signature[:32], "big")
        s = int.from_bytes(signature[32:64], "big")
        v = signature[64]
        if v < 27:
            v += 27
        return EC.recover(digest, v, r, s)

    def is_valid(self, domain_name: str, key: int) -> bool:
        from ..utils.keccak import keccak_256

        dom = keccak_256(domain_name.encode())
        return bool(self.keys.get((dom, key))) and not self.revoked.get(key)

    def set_key(self, selector: str, domain_name: str, key: int, signature: bytes):
        from ..utils.keccak import keccak_256

        _require(len(selector) > 0, "Invalid selector")
        _require(len(domain_name) > 0, "Invalid domain name")
        _require(key != 0, "Invalid public key hash")
        _require(not self.is_valid(domain_name, key), "publicKeyHash is already set")
        _require(not self.revoked.get(key), "publicKeyHash is revoked")
        msg = self.compute_signed_msg(self.SET_PREFIX, domain_name, key)
        _require(self._recover(msg, signature) == self.signer, "Invalid signature")
        self.keys[(keccak_256(domain_name.encode()), key)] = True

    def revoke_key(self, selector: str, domain_name: str, key: int, signature: bytes):
        _require(len(selector) > 0, "Invalid selector")
        _require(len(domain_name) > 0, "Invalid domain name")
        _require(key != 0, "Invalid public key hash")
        _require(self.is_valid(domain_name, key), "publicKeyHash is not set")
        _require(not self.revoked.get(key), "publicKeyHash is already revoked")
        msg = self.compute_signed_msg(self.REVOKE_PREFIX, domain_name, key)
        _require(self._recover(msg, signature) == self.signer, "Invalid signature")
        self.revoked[key] = True


# ----------------------------------------- UserOverrideableDKIMRegistry model
class RevertError(AssertionError):
    """Mirror of a Solidity require() revert (message == require string)."""


def _require(cond, msg):
    if not cond:
        raise RevertError(msg)


def eth_signed_digest(message: bytes) -> bytes:
    """EIP-191 personal-sign digest (OZ MessageHashUtils.toEthSignedMessageHash)."""
    from ..utils.keccak import keccak_256

    return keccak_256(b"\x19Ethereum Signed Message:\n" + str(len(message)).encode() + message)


def to_hex_string(value: int) -> str:
    """OZ Strings.toHexString(uint256): 0x-prefixed, minimal BYTE length
    (so 1 -> "0x01", reference test expectation `public_key_hash=0x01;`)."""
    n = max(1, (value.bit_length() + 7) // 8)
    return "0x" + value.to_bytes(n, "big").hex()


def compute_signed_msg(prefix: str, domain_name: str, public_key_hash: int) -> str:
    """UserOverrideableDKIMRegistry.computeSignedMsg (reference :380-392):
    `<prefix>domain=<name>;public_key_hash=<0x-hex>;`."""
    return f"{prefix}domain={domain_name};public_key_hash={to_hex_string(public_key_hash)};"


@dataclass
class ERC1271Wallet:
    """ExampleERC1271 stand-in: a contract wallet owned by an EOA key."""

    owner_priv: int

    def is_valid_signature(self, digest: bytes, signature: bytes) -> bool:
        from ..utils import secp256k1 as EC

        if len(signature) != 65:
            return False
        r = int.from_bytes(signature[:32], "big")
        s = int.from_bytes(signature[32:64], "big")
        v = signature[64]
        if v < 27:
            v += 27
        return EC.recover(digest, v, r, s) == EC.privkey_to_address(self.owner_priv)


@dataclass
class UserOverrideableRegistryModel:
    """Executable mirror of UserOverrideableDKIMRegistry.sol (this repo's
    rewrite of reference :19-449): threshold validity, EIP-191 ECDSA /
    EIP-1271 relayer signature flows, delay / override / reactivate.

    Addresses are lowercase hex strings; `contracts` maps a contract-wallet
    address to its ERC1271Wallet model (address.code.length > 0 analog).
    """

    main_authorizer: str
    set_timestamp_delay: int
    owner: str = "0xowner"
    now: int = 0
    approved: dict = field(default_factory=dict)  # (domHash, key, who) -> True
    revoked: dict = field(default_factory=dict)  # (key, who) -> True
    reactivated: dict = field(default_factory=dict)  # (key, who) -> True
    enabled_time: dict = field(default_factory=dict)  # key -> ts
    contracts: dict = field(default_factory=dict)  # addr -> ERC1271Wallet

    SET_PREFIX = "SET:"
    REVOKE_PREFIX = "REVOKE:"
    REACTIVATE_PREFIX = "REACTIVATE:"
    ZERO = "0x" + "00" * 20

    # ------------------------------------------------------------ signature
    def _check_signature(self, prefix, domain_name, key, authorizer, signature):
        from ..utils import secp256k1 as EC

        msg = compute_signed_msg(prefix, domain_name, key).encode()
        digest = eth_signed_digest(msg)
        wallet = self.contracts.get(authorizer)
        if wallet is not None:
            _require(
                wallet.is_valid_signature(digest, signature),
                "invalid eip1271 signature",
            )
            return
        _require(signature is not None and len(signature) == 65, "invalid signature length")
        r = int.from_bytes(signature[:32], "big")
        s = int.from_bytes(signature[32:64], "big")
        v = signature[64]
        if v < 27:
            v += 27
        _require(EC.recover(digest, v, r, s) == authorizer, "invalid ecdsa signature")

    # ------------------------------------------------------------ mutations
    def set_key(self, domain_name, key, authorizer, sender=None, signature=None):
        from ..utils.keccak import keccak_256

        sender = sender or authorizer
        _require(len(domain_name) > 0, "domain name cannot be zero")
        _require(key != 0, "public key hash cannot be zero")
        _require(authorizer not in (None, "", self.ZERO), "authorizer address cannot be zero")
        dom = keccak_256(domain_name.encode())
        _require(not self.approved.get((dom, key, authorizer)), "public key hash is already set")
        _require(not self.revoked.get((key, authorizer)), "public key hash is already revoked")
        if sender != authorizer:
            self._check_signature(self.SET_PREFIX, domain_name, key, authorizer, signature)
        self.approved[(dom, key, authorizer)] = True
        if authorizer == self.main_authorizer:
            self.enabled_time[key] = self.now + self.set_timestamp_delay

    def revoke(self, domain_name, key, authorizer, sender=None, signature=None):
        sender = sender or authorizer
        _require(len(domain_name) > 0, "domain name cannot be zero")
        _require(key != 0, "public key hash cannot be zero")
        _require(authorizer not in (None, "", self.ZERO), "authorizer address cannot be zero")
        _require(not self.revoked.get((key, authorizer)), "public key hash is already revoked")
        if sender != authorizer:
            self._check_signature(self.REVOKE_PREFIX, domain_name, key, authorizer, signature)
        self.revoked[(key, authorizer)] = True

    def reactivate(self, domain_name, key, authorizer, sender=None, signature=None):
        from ..utils.keccak import keccak_256

        sender = sender or authorizer
        _require(authorizer not in (None, "", self.ZERO), "authorizer address cannot be zero")
        _require(
            authorizer != self.main_authorizer,
            "mainAuthorizer cannot reactivate the public key hash",
        )
        _require(
            not self.reactivated.get((key, authorizer)),
            "public key hash is already reactivated",
        )
        _require(self._revoke_threshold(key, authorizer) == 1, "revoke threshold must be one")
        dom = keccak_256(domain_name.encode())
        _require(
            self._set_threshold(dom, key, authorizer) >= 2,
            "set threshold must be larger than two",
        )
        if sender != authorizer:
            self._check_signature(self.REACTIVATE_PREFIX, domain_name, key, authorizer, signature)
        self.reactivated[(key, authorizer)] = True

    def change_main_authorizer(self, new_main, sender):
        _require(sender == self.owner, "not the owner")
        _require(new_main not in (None, "", self.ZERO), "newMainAuthorizer address cannot be zero")
        _require(new_main != self.main_authorizer,
                 "newMainAuthorizer address cannot be the same as the current mainAuthorizer")
        self.main_authorizer = new_main

    # ------------------------------------------------------------ validity
    def _set_threshold(self, dom, key, authorizer) -> int:
        t = 0
        if self.approved.get((dom, key, self.main_authorizer)):
            t += 1 if self.now < self.enabled_time.get(key, 0) else 2
        if self.approved.get((dom, key, authorizer)):
            t += 2
        return t

    def _revoke_threshold(self, key, authorizer) -> int:
        t = 0
        if self.revoked.get((key, self.main_authorizer)):
            t += 1
        if self.revoked.get((key, authorizer)):
            t += 2
        if t == 1 and self.reactivated.get((key, authorizer)):
            t -= 1
        return t

    def is_valid(self, domain_name, key, authorizer) -> bool:
        from ..utils.keccak import keccak_256

        _require(authorizer != self.main_authorizer, "authorizer cannot be mainAuthorizer")
        dom = keccak_256(domain_name.encode())
        if self._revoke_threshold(key, authorizer) >= 1:
            return False
        return self._set_threshold(dom, key, authorizer) >= 2
