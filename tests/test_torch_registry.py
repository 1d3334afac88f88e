"""The port's contract models, keccak, secp256k1 and DKIM registry updater
against the JAX package on the CPU.

Every flow of tests/test_contracts_registry_flows.py and
tests/test_contracts_scripts.py runs through both packages' models and
records each step's outcome (its value, or the revert or error and its
message); the two traces must be equal. Tolerance: exact equality."""

import json
import random

import pytest

from zkemail_tpu.contracts import reference_impl as JM
from zkemail_tpu.scripts import update_dkim_registry as JU
from zkemail_tpu.utils import keccak as JK
from zkemail_tpu.utils import secp256k1 as JEC
from zkemail_tpu_torch.contracts import reference_impl as TM
from zkemail_tpu_torch.helpers.dns import StaticResolver
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner, LocalEd25519DKIMSigner
from zkemail_tpu_torch.scripts import update_dkim_registry as TU
from zkemail_tpu_torch.utils import keccak as TK
from zkemail_tpu_torch.utils import secp256k1 as TEC

DOMAIN = "example.com"
KEY = 1
DELAY = 1000


class Run:
    """One package's models, and the trace of a flow's outcomes."""

    def __init__(self, M, EC):
        self.M, self.EC = M, EC
        self.trace = []
        self.MAIN, self.USER1, self.USER2 = (EC.privkey_to_address(k) for k in (1, 2, 3))
        self.reg = M.UserOverrideableRegistryModel(self.MAIN, DELAY, owner="0xdeployer", now=0)

    def sig(self, priv, prefix, domain=DOMAIN, key=KEY):
        digest = self.M.eth_signed_digest(self.M.compute_signed_msg(prefix, domain, key).encode())
        return self.EC.sig_bytes(*self.EC.sign(priv, digest))

    def do(self, fn):
        try:
            self.trace.append(("ok", fn()))
        except self.M.RevertError as exc:
            self.trace.append(("revert", str(exc)))
        except (ValueError, IndexError) as exc:
            self.trace.append((type(exc).__name__, str(exc)))

    def valid(self, authorizer, key=KEY):
        self.do(lambda: self.reg.is_valid(DOMAIN, key, authorizer))


def _set(r, auth, sender, **kw):
    r.do(lambda: r.reg.set_key(DOMAIN, kw.pop("key", KEY), auth, sender=sender, **kw))


def _revoke(r, auth, sender, **kw):
    r.do(lambda: r.reg.revoke(DOMAIN, KEY, auth, sender=sender, **kw))


def _reactivate(r, auth, sender, **kw):
    r.do(lambda: r.reg.reactivate(DOMAIN, KEY, auth, sender=sender, **kw))


def _at(r, now):
    r.reg.now = now


def flow_set_by_user1(r):
    _set(r, r.USER1, r.USER1)
    r.valid(r.USER1)


def flow_set_by_main_before_and_after_enabled(r):
    _set(r, r.MAIN, r.MAIN)
    r.valid(r.USER1)
    _set(r, r.USER1, r.USER1)
    r.valid(r.USER1)
    r.valid(r.USER2)
    _at(r, DELAY)
    r.valid(r.USER2)


def flow_set_by_main_ecdsa_relayer(r):
    _set(r, r.MAIN, r.USER1, signature=r.sig(1, r.reg.SET_PREFIX))
    r.valid(r.USER1)
    _at(r, DELAY)
    r.valid(r.USER1)


def flow_eip1271(r):
    wallet = "0xmainwallet"
    r.reg.contracts[wallet] = r.M.ERC1271Wallet(1)
    _set(r, wallet, r.USER1, signature=r.sig(3, r.reg.SET_PREFIX))  # wrong signer
    r.reg.main_authorizer = wallet
    _set(r, wallet, r.USER1, signature=r.sig(1, r.reg.SET_PREFIX))
    _at(r, DELAY)
    r.valid(r.USER1)


def flow_invalid_ecdsa(r):
    _set(r, r.MAIN, r.USER1, signature=r.sig(3, r.reg.SET_PREFIX))
    _set(r, r.MAIN, r.USER1, signature=b"\x00" * 65)


def flow_zero_args_and_twice(r):
    r.do(lambda: r.reg.set_key("", KEY, r.USER1, sender=r.USER1))
    _set(r, r.USER1, r.USER1, key=0)
    _set(r, r.MAIN, r.MAIN)
    _set(r, r.MAIN, r.MAIN)


def flow_revokes(r):
    _revoke(r, r.USER1, r.USER1)  # no prior set needed; blocks user1's set
    _set(r, r.USER1, r.USER1)
    _set(r, r.USER2, r.USER2)
    _set(r, r.MAIN, r.MAIN)
    _at(r, DELAY)
    r.valid(r.USER2)
    _revoke(r, r.USER2, r.USER2)
    _revoke(r, r.USER2, r.USER2)
    r.valid(r.USER2)
    _revoke(r, r.MAIN, r.USER1, signature=r.sig(1, r.reg.REVOKE_PREFIX))
    r.valid(r.USER1)


def flow_reactivate(r):
    _set(r, r.MAIN, r.MAIN)
    _set(r, r.USER1, r.USER1)
    _reactivate(r, r.USER1, r.USER1)  # no main revoke yet
    _at(r, DELAY)
    _revoke(r, r.MAIN, r.MAIN)
    r.valid(r.USER1)
    _reactivate(r, r.MAIN, r.MAIN)
    _reactivate(r, r.USER1, r.USER2, signature=r.sig(2, r.reg.REACTIVATE_PREFIX))
    r.valid(r.USER1)
    r.valid(r.USER2)
    _revoke(r, r.USER1, r.USER1)
    _reactivate(r, r.USER1, r.USER1)


def flow_reactivate_before_enabled(r):
    _set(r, r.MAIN, r.MAIN)
    _revoke(r, r.MAIN, r.MAIN)
    _reactivate(r, r.USER1, r.USER1)


def flow_admin(r):
    r.do(lambda: r.reg.change_main_authorizer(r.USER2, sender=r.USER1))
    r.do(lambda: r.reg.change_main_authorizer(r.USER2, sender="0xdeployer"))
    r.do(lambda: r.reg.main_authorizer)
    r.do(lambda: r.reg.change_main_authorizer(r.USER2, sender="0xdeployer"))
    r.valid(r.USER2)


def flow_signed_msgs(r):
    for prefix in ("SET:", "REVOKE:", "REACTIVATE:"):
        r.do(lambda: r.M.compute_signed_msg(prefix, DOMAIN, KEY))
        r.do(lambda: r.M.compute_signed_msg(prefix, "sub.example.org", 2**255 + 12345))
    for v in (0, 1, 255, 2**64, 2**256 - 1):
        r.do(lambda: r.M.to_hex_string(v))
    r.do(lambda: r.M.eth_signed_digest(b"SET:domain=example.com;"))


def flow_ecdsa_owned(r):
    m = r.M.ECDSAOwnedRegistryModel(signer=r.MAIN)
    r.do(lambda: m.compute_signed_msg("SET:", DOMAIN, KEY))
    r.do(lambda: m.set_key("sel", DOMAIN, KEY, r.sig(2, "SET:")))  # wrong signer
    r.do(lambda: m.set_key("20230601", DOMAIN, KEY, r.sig(1, "SET:")))
    r.do(lambda: m.is_valid(DOMAIN, KEY))
    r.do(lambda: m.set_key("20230601", DOMAIN, KEY, r.sig(1, "SET:")))
    r.do(lambda: m.revoke_key("20230601", DOMAIN, KEY, r.sig(1, "REVOKE:")))
    r.do(lambda: m.is_valid(DOMAIN, KEY))
    r.do(lambda: m.revoke_key("20230601", DOMAIN, KEY, r.sig(1, "REVOKE:")))


def flow_overrideable_smoke(r):
    m = r.M.UserOverrideableRegistryModel("0xmain", set_timestamp_delay=100, now=0)
    dom = "d.example"
    for step in (
        lambda: m.set_key(dom, 7, "0xmain", sender="0xmain"),
        lambda: m.is_valid(dom, 7, "0xuser1"),
        lambda: setattr(m, "now", 100),
        lambda: m.is_valid(dom, 7, "0xuser1"),
        lambda: m.set_key(dom, 8, "0xuser2", sender="0xuser2"),
        lambda: (m.is_valid(dom, 8, "0xuser2"), m.is_valid(dom, 8, "0xuser1")),
        lambda: m.revoke(dom, 7, "0xmain", sender="0xmain"),
        lambda: m.set_key(dom, 7, "0xuser1", sender="0xuser1"),
        lambda: m.reactivate(dom, 7, "0xuser1", sender="0xuser1"),
        lambda: (m.is_valid(dom, 7, "0xuser1"), m.is_valid(dom, 7, "0xuser3")),
        lambda: m.revoke(dom, 8, "0xuser2", sender="0xuser2"),
        lambda: m.is_valid(dom, 8, "0xuser2"),
    ):
        r.do(step)


def flow_circom_packing(r):
    M = r.M
    for data in (b"reveal-me@zkemail.example", b"", bytes(range(1, 100)), b"a\x00b\x00"):
        r.do(lambda: M.circom_pack_fields(data))
        r.do(lambda: M.circom_unpack_fields(M.circom_pack_fields(data), len(data)))
        r.do(lambda: M.convert_packed_bytes_to_string(M.circom_pack_fields(data)))
        for padded in (31, 62, 124):
            r.do(lambda: M.circom_pack_fields_padded(data, padded))
            r.do(lambda: M.circom_unpack_fields_padded(M.circom_pack_fields_padded(data, padded),
                                                       padded))
    r.do(lambda: M.circom_unpack_fields_padded([1], 62))
    r.do(lambda: (M.circom_pack_bool(True), M.circom_pack_bool(False),
                  M.circom_unpack_bool([1]), M.circom_unpack_bool([0])))
    r.do(lambda: M.get_domain_from_email("alice@sub.example.com"))


def flow_noir_packing(r):
    M = r.M
    data = bytes(range(1, 60))
    for n in (1, 2, 3):
        r.do(lambda: M.noir_pack_fields(data, n))
    r.do(lambda: M.noir_unpack_fields(M.noir_pack_fields(data, 2)))
    for n in (len(data), 60, 65):
        r.do(lambda: M.noir_pack_bounded_vec_u8(data, n))
    r.do(lambda: M.noir_unpack_bounded_vec_u8(M.noir_pack_bounded_vec_u8(data, 65)))


FLOWS = {name[5:]: fn for name, fn in globals().items() if name.startswith("flow_")}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_registry_flows_equal_jax(flow):
    runs = [Run(JM, JEC), Run(TM, TEC)]
    for r in runs:
        FLOWS[flow](r)
    assert runs[0].trace and runs[1].trace == runs[0].trace


def test_keccak_and_secp256k1_equal_jax():
    rng = random.Random(3)
    assert TK.keccak_256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    for n in (0, 1, 31, 32, 135, 136, 137, 271, 272, 500):
        data = rng.randbytes(n)
        assert TK.keccak_256(data) == JK.keccak_256(data)
    for priv in (1, 2, rng.getrandbits(255)):
        assert TEC.privkey_to_address(priv) == JEC.privkey_to_address(priv)
        digest = rng.randbytes(32)
        v, r, s = TEC.sign(priv, digest)
        assert (v, r, s) == JEC.sign(priv, digest)
        assert TEC.sig_bytes(v, r, s) == JEC.sig_bytes(v, r, s)
        assert TEC.recover(digest, v, r, s) == JEC.recover(digest, v, r, s) == (
            TEC.privkey_to_address(priv))
        assert TEC.recover(digest, v ^ 1, r, s) == JEC.recover(digest, v ^ 1, r, s)


@pytest.fixture(scope="module")
def signers():
    return [LocalDKIMSigner(domain=d, selector=s, key_size=1024, seed=i)
            for i, (d, s) in enumerate([("corp.example", "selector1"), ("corp.example", "google"),
                                        ("mail.example", "s1")])]


def test_crawl_and_calldata_equal_jax(signers):
    table = {(s.domain, s.selector): [s.public_key] for s in signers}
    domains = ["corp.example", "nokeys.example", "mail.example"]
    t = TU.crawl_domains(domains, resolver=StaticResolver(table))
    j = JU.crawl_domains(domains, resolver=StaticResolver(table))
    assert json.dumps(t) == json.dumps(j)
    assert json.dumps(TU.registry_calldata(t)) == json.dumps(JU.registry_calldata(j))
    assert TU.COMMON_SELECTORS == JU.COMMON_SELECTORS
    assert [TU.pubkey_hash(s.public_key[0]) for s in signers] == [
        JU.pubkey_hash(s.public_key[0]) for s in signers]


def test_update_registry_main_equal_jax(signers, tmp_path, capsys):
    local = {}
    for s in signers:
        local.setdefault(s.domain, {})[s.selector] = s.dns_txt_record()
    keys = tmp_path / "keys.json"
    keys.write_text(json.dumps(local))
    outs = []
    for mod in (JU, TU):
        out = tmp_path / f"{mod.__name__}.json"
        mod.main(["--local-keys", str(keys), "--domains", "corp.example", "mail.example",
                  "--output", str(out)])
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    assert len(json.loads(outs[1])["keys"]["corp.example"]) == 2


def test_ed25519_key_skipped_by_the_port_crawl(signers):
    """A crawled ed25519 key: the port skips it (the registry holds RSA key
    hashes); the JAX crawl fails on it with a TypeError."""
    ed = LocalEd25519DKIMSigner(domain="corp.example", selector="selector1", seed=2)
    rsa = signers[1]
    table = {("corp.example", "selector1"): [ed.public_key],
             ("corp.example", "google"): [rsa.public_key]}
    t = TU.crawl_domains(["corp.example"], resolver=StaticResolver(table))
    assert [e["selector"] for e in t["corp.example"]] == ["google"]
    rsa_only = JU.crawl_domains(["corp.example"], resolver=StaticResolver(
        {("corp.example", "google"): [rsa.public_key]}))
    assert json.dumps(t) == json.dumps(rsa_only)
    with pytest.raises(TypeError):
        JU.crawl_domains(["corp.example"], resolver=StaticResolver(table))
