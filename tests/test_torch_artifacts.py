"""The port's proving keys on disk against the JAX package's, on the CPU:
chunked artifacts (``prover/artifacts.py``), snarkjs ``.zkey`` containers
(``prover/zkey.py``) and the setup cache (``prover/setup.py::
groth16_setup_cached``).

On the toy circuit of tests/test_zkey.py, with one JAX setup carried across
(``prover/convert.py::proving_key_from_arrays``): the port's export has the
JAX export's manifest and decompressed chunk bytes; each package loads the
other's files to equal limbs; ``write_zkey`` gives the JAX bytes and
``read_zkey`` the JAX points, coefficients and constraint count (also with
materialized instance rows); a loaded key proves what the original key
proves under one seeded rng; garbage, corrupt chunks, stale formats and
short or long streams are refused; ``download_chunked`` retries and caches;
the setup cache misses, then hits with an equal key. The JAX setup (seed 9)
and its zkey bytes are frozen by tests/make_jax_reference.py. Tolerance:
exact equality."""

import gzip
import json
import random
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import make_jax_reference as JR
from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)
from zkemail_tpu.circuits.builder import ConstraintSystem as JCS
from zkemail_tpu.prover import artifacts as JA
from zkemail_tpu.prover import zkey as JZ
from zkemail_tpu_torch.circuits.builder import ConstraintSystem as TCS
from zkemail_tpu_torch.prover import artifacts as TA
from zkemail_tpu_torch.prover import zkey as TZ
from zkemail_tpu_torch.prover.containers import verify
from zkemail_tpu_torch.prover.convert import proving_key_from_arrays
from zkemail_tpu_torch.prover.groth16 import prove_batch
from zkemail_tpu_torch.prover.setup import groth16_setup_cached, setup_cache_key

torch.set_num_threads(2)

QUERIES = ("a_query", "b1_query", "b2_query", "c_query", "h_query")
XS = [5]


def toy(cs_cls, const: int = 3):
    """x (private), y = x^2 + x + const (public), as tests/test_zkey.py."""
    cs = cs_cls("zkeytoy")
    x = cs.add_input("x", ())
    x2 = cs.mul(x, x)
    y = cs.define(x2 + x + const)
    cs.mark_public(y)
    return cs.compile()


def _g1(p):
    return (True,) if p.inf else (False, int(p.x), int(p.y))


def _g2(p):
    return (True,) if p.inf else (False, int(p.x.c0), int(p.x.c1), int(p.y.c0), int(p.y.c1))


def carry(pk):
    """A JAX ProvingKey -> the port's on the CPU, through numpy and ints."""
    def g1(p):
        return None if p.inf else (p.x, p.y)

    def g2(p):
        return None if p.inf else ((p.x.c0, p.x.c1), (p.y.c0, p.y.c1))

    queries = {
        q: {k: tuple(np.asarray(c) for c in v) if isinstance(v, tuple) else np.asarray(v)
            for k, v in getattr(pk, q).items()}
        for q in QUERIES
    }
    points = {"alpha_g1": g1(pk.alpha_g1), "beta_g1": g1(pk.beta_g1),
              "delta_g1": g1(pk.delta_g1), "beta_g2": g2(pk.beta_g2),
              "delta_g2": g2(pk.delta_g2), "gamma_g2": g2(pk.vk.gamma_g2)}
    return proving_key_from_arrays(
        domain_log2=pk.domain_log2, n_public=pk.n_public, n_constraints=pk.n_constraints,
        queries=queries, points=points, ic=[g1(p) for p in pk.vk.ic], device="cpu")


def tables(pk) -> dict:
    """Every query coordinate of a key (either package) as a numpy array."""
    out = {}
    for q in QUERIES:
        for k, v in getattr(pk, q).items():
            for i, c in enumerate(v if isinstance(v, tuple) else (v,)):
                out[(q, k, i)] = c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
    return out


def assert_keys_equal(a, b):
    ta, tb = tables(a), tables(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype == np.int32 and np.array_equal(ta[k], tb[k]), k
    assert (a.domain_log2, a.n_public, a.n_constraints) == (b.domain_log2, b.n_public,
                                                            b.n_constraints)
    for name in ("alpha_g1", "beta_g1", "delta_g1"):
        assert _g1(getattr(a, name)) == _g1(getattr(b, name))
    for name in ("beta_g2", "delta_g2"):
        assert _g2(getattr(a, name)) == _g2(getattr(b, name))
    assert _g1(a.vk.alpha_g1) == _g1(b.vk.alpha_g1)
    assert [_g2(getattr(a.vk, n)) for n in ("beta_g2", "gamma_g2", "delta_g2")] == [
        _g2(getattr(b.vk, n)) for n in ("beta_g2", "gamma_g2", "delta_g2")]
    assert [_g1(p) for p in a.vk.ic] == [_g1(p) for p in b.vk.ic]


def witness(cc):
    """(L, n_signals, B) witness of the port's toy for XS."""
    return cc.eval_witness({"x": torch.tensor(XS, dtype=torch.int32)}, len(XS), device="cpu")


def proofs(pk, cc, w):
    out = prove_batch(pk, cc, w, rng=random.Random(7), device="cpu")
    for proof, publics in out:
        assert verify(pk.vk, proof, publics)
        assert not verify(pk.vk, proof, [publics[0] + 1])
    return [(_g1(p.a), _g2(p.b), _g1(p.c), tuple(pub)) for p, pub in out]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """One JAX setup, its chunked export and its zkey bytes (with and
    without coefficients); the carried key, the port's circuit and the
    original key's proofs."""
    jcc = toy(JCS)
    arrays, meta = JR.read("zkeytoy_key_seed9")
    jpk = JR.key_from(arrays, meta)
    jdir = tmp_path_factory.mktemp("jax_chunks")
    manifest = JA.export_chunked(jpk, str(jdir), name="toy", n_chunks=4)
    cc = toy(TCS)
    for m in "ABC":
        for x, y in zip(getattr(jcc, m), getattr(cc, m)):
            assert np.array_equal(x, y)
    pk = carry(jpk)
    w = witness(cc)
    return SimpleNamespace(jcc=jcc, jpk=jpk, jdir=jdir, manifest=manifest,
                           zkey=arrays["zkey"].tobytes(), zkey_bare=arrays["zkey_bare"].tobytes(),
                           cc=cc, pk=pk, w=w, proofs=proofs(pk, cc, w))


# ---------------------------------------------------------------------------
# chunked artifacts
# ---------------------------------------------------------------------------

def test_export_equals_jax(ref, tmp_path):
    manifest = TA.export_chunked(ref.pk, str(tmp_path), name="toy", n_chunks=4)
    assert manifest == ref.manifest
    assert (tmp_path / "toy.manifest.json").read_text() == (
        ref.jdir / "toy.manifest.json").read_text()
    assert [c["file"][-4:-3] for c in manifest["chunks"]] == ["b", "c", "d", "e"]
    for ch in manifest["chunks"]:
        # the gzip header holds an mtime: compare what the chunks hold
        ours = gzip.decompress((tmp_path / ch["file"]).read_bytes())
        assert ours == gzip.decompress((ref.jdir / ch["file"]).read_bytes())
        assert len(ours) == ch["bytes"]


def test_port_loads_jax_export(ref):
    pk = TA.load_chunked(str(ref.jdir), name="toy", device="cpu")
    assert pk.device == torch.device("cpu") and pk.cache == {}
    assert_keys_equal(pk, ref.pk)
    assert_keys_equal(pk, ref.jpk)


def test_jax_loads_port_export(ref, tmp_path):
    TA.export_chunked(ref.pk, str(tmp_path), name="toy", n_chunks=3)
    assert_keys_equal(JA.load_chunked(str(tmp_path), name="toy"), ref.jpk)


def test_loaded_key_proves_as_original(ref, tmp_path):
    """A key that went through both formats (zkey written and read, then
    exported and loaded as chunks) proves what the original key proves
    under one seeded rng (the zkey holds the points affine, so the tables
    differ from the setup's projective ones); its signal plan is rebuilt
    on first use. A CPU prove takes some 25 s, so one prove covers both
    loaders; each loader's key equals the JAX package's in the other tests."""
    TZ.write_zkey_file(ref.pk, str(tmp_path / "toy.zkey"), ref.cc)
    pk, _ = TZ.read_zkey_file(str(tmp_path / "toy.zkey"), device="cpu")
    TA.export_chunked(pk, str(tmp_path), name="toy")
    pk = TA.load_chunked(str(tmp_path), name="toy", device="cpu")
    assert "signal_plan" not in pk.cache
    assert proofs(pk, ref.cc, ref.w) == ref.proofs
    assert "signal_plan" in pk.cache


def _rewrite_manifest(path, **changes):
    man = json.loads(path.read_text())
    man.update(changes)
    path.write_text(json.dumps(man))


def _corrupt_chunk(d):
    f = d / "toy.pkchunkc.gz"
    blob = bytearray(gzip.decompress(f.read_bytes()))
    blob[7] ^= 0xFF
    f.write_bytes(gzip.compress(bytes(blob)))


def _wrong_size(d):
    man = json.loads((d / "toy.manifest.json").read_text())
    man["chunks"][0]["bytes"] += 4
    (d / "toy.manifest.json").write_text(json.dumps(man))


def _trailing(d):
    man = json.loads((d / "toy.manifest.json").read_text())
    _rewrite_manifest(d / "toy.manifest.json", schema=man["schema"][:-1])


@pytest.mark.parametrize("case,match", [
    ("corrupt_chunk", "integrity"),
    ("stale_format", "format_version"),
    ("no_n_constraints", "format_version"),
    ("wrong_size", "size mismatch"),
    ("trailing_data", "trailing data"),
])
def test_load_refuses_like_jax(ref, tmp_path, case, match):
    """Each broken export is refused by both packages' load_chunked."""
    TA.export_chunked(ref.pk, str(tmp_path), name="toy", n_chunks=2)
    man_path = tmp_path / "toy.manifest.json"
    if case == "corrupt_chunk":
        _corrupt_chunk(tmp_path)
    elif case == "stale_format":
        _rewrite_manifest(man_path, format_version=2)
    elif case == "no_n_constraints":
        man = json.loads(man_path.read_text())
        del man["n_constraints"]
        man_path.write_text(json.dumps(man))
    elif case == "wrong_size":
        _wrong_size(tmp_path)
    else:
        _trailing(tmp_path)
    with pytest.raises(ValueError, match=match):
        TA.load_chunked(str(tmp_path), name="toy", device="cpu")
    with pytest.raises(ValueError):
        JA.load_chunked(str(tmp_path), name="toy")


def test_download_chunked_retries_and_cache(ref, tmp_path):
    """A local fetch that fails once per chunk c: one retry; then the
    intact cache is not fetched again (tests/test_artifacts.py)."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    TA.export_chunked(ref.pk, str(src), name="dl", n_chunks=3)
    calls, log = {}, []

    def flaky(url):
        fname = url.rsplit("/", 1)[1]
        calls[fname] = calls.get(fname, 0) + 1
        if calls[fname] == 1 and fname.endswith("chunkc.gz"):
            raise IOError("transient")
        return (src / fname).read_bytes()

    pk = TA.download_chunked("http://example/zk", str(dst), name="dl", fetch=flaky,
                             progress=log.append, device="cpu")
    assert_keys_equal(pk, ref.pk)
    assert calls["dl.pkchunkc.gz"] == 2 and any("attempt 1/3 failed" in m for m in log)
    calls.clear()
    TA.download_chunked("http://example/zk", str(dst), name="dl", fetch=flaky, device="cpu")
    assert not any(k.endswith(".gz") for k in calls)  # cache hit
    (dst / "dl.pkchunkd.gz").write_bytes(gzip.compress(b"garbage"))
    TA.download_chunked("http://example/zk", str(dst), name="dl", fetch=flaky, device="cpu")
    assert calls == {"dl.pkchunkd.gz": 1}  # only the damaged chunk is fetched again

    def down(url):
        raise IOError("offline")

    with pytest.raises(RuntimeError, match="after 2 attempts"):
        TA.download_chunked("http://example/zk", str(tmp_path / "empty"), name="dl",
                            retries=2, fetch=down, device="cpu")


# ---------------------------------------------------------------------------
# .zkey
# ---------------------------------------------------------------------------

def test_write_zkey_bytes_equal_jax(ref, tmp_path):
    assert TZ.write_zkey(ref.pk, ref.cc) == ref.zkey
    assert TZ.write_zkey(ref.pk) == ref.zkey_bare
    TZ.write_zkey_file(ref.pk, str(tmp_path / "toy.zkey"), ref.cc)
    assert (tmp_path / "toy.zkey").read_bytes() == ref.zkey


def _coeff_lists(coeffs):
    return {m: tuple([int(v) for v in part] for part in coeffs[m]) for m in ("A", "B")}


def _with_instance_rows(blob, pk):
    """The zkey with n_public + 1 more instance rows in section 4
    (tests/test_zkey.py's materialized-rows case)."""
    _v, n_sections = struct.unpack_from("<II", blob, 4)
    off, parts = 12, [blob[:12]]
    for _ in range(n_sections):
        stype, size = struct.unpack_from("<IQ", blob, off)
        payload = blob[off + 12 : off + 12 + size]
        if stype == 4:
            n_coeffs = struct.unpack_from("<I", payload, 0)[0]
            extra = b"".join(struct.pack("<III", 0, pk.n_constraints + s, s) + JZ._fr_bytes(1)
                             for s in range(pk.n_public + 1))
            payload = struct.pack("<I", n_coeffs + pk.n_public + 1) + payload[4:] + extra
        parts.append(struct.pack("<IQ", stype, len(payload)) + payload)
        off += 12 + size
    return b"".join(parts)


def _non_canonical(blob):
    """The zkey with every coordinate of section 5 (the a query) that has
    room below 2^256 stored as its value plus q: not reduced, the same
    point."""
    off = 12
    while True:
        stype, size = struct.unpack_from("<IQ", blob, off)
        if stype == 5:
            break
        off += 12 + size
    out = bytearray(blob)
    for o in range(off + 12, off + 12 + size, 32):
        v = int.from_bytes(out[o : o + 32], "little") + JZ.Q
        if v < 1 << 256:
            out[o : o + 32] = v.to_bytes(32, "little")
    assert bytes(out) != blob
    return bytes(out)


@pytest.mark.parametrize("case", ["with_coeffs", "bare", "materialized_rows", "non_canonical"])
def test_read_zkey_equals_jax(ref, case):
    """read_zkey of the JAX bytes (also with materialized instance rows,
    and with unreduced coordinates): the JAX read_zkey's tables, host
    points, coefficients and inferred constraint count; written again and
    read back, the same key."""
    blob = {"with_coeffs": ref.zkey, "bare": ref.zkey_bare,
            "materialized_rows": _with_instance_rows(ref.zkey, ref.jpk),
            "non_canonical": _non_canonical(ref.zkey)}[case]
    jpk, jcoeffs = JZ.read_zkey(blob)
    pk, coeffs = TZ.read_zkey(blob, device="cpu")
    assert pk.device == torch.device("cpu") and pk.cache == {}
    assert_keys_equal(pk, jpk)
    assert _coeff_lists(coeffs) == _coeff_lists(jcoeffs)
    assert coeffs["A"][0].dtype == np.int64
    if case != "bare":
        assert pk.n_constraints == ref.pk.n_constraints
    if case == "materialized_rows":
        assert max(coeffs["A"][0]) == pk.n_constraints + pk.n_public
    # a zkey round trip does not change the key the prover sees
    again = TZ.write_zkey(pk, None if case == "bare" else ref.cc)
    assert_keys_equal(TZ.read_zkey(again, device="cpu")[0], jpk)


def test_zkey_refuses_garbage(ref):
    with pytest.raises(ValueError, match="magic"):
        TZ.read_zkey(b"nope" + bytes(100), device="cpu")
    other = bytearray(ref.zkey)
    other[24:28] = struct.pack("<I", 2)  # section 1: prover type 2 (plonk)
    with pytest.raises(ValueError, match="prover type"):
        TZ.read_zkey(bytes(other), device="cpu")


# ---------------------------------------------------------------------------
# the setup cache
# ---------------------------------------------------------------------------

def test_setup_cached_miss_then_hit(ref, tmp_path, monkeypatch):
    import zkemail_tpu.prover.setup as JS

    key = setup_cache_key(ref.cc, 9)
    pk = groth16_setup_cached(ref.cc, seed=9, cache_dir=str(tmp_path), device="cpu")
    assert_keys_equal(pk, ref.pk)  # the port's setup is the JAX one
    assert [p.name for p in tmp_path.iterdir()] == [f"{key}.chunked"]
    hit = groth16_setup_cached(ref.cc, seed=9, cache_dir=str(tmp_path), device="cpu")
    assert hit.cache == {} and hit.device == torch.device("cpu")
    assert_keys_equal(hit, pk)
    # the JAX package's pickle of the same key (its setup stubbed by the
    # fixture's key) lands beside it under the same cache key
    monkeypatch.setattr(JS, "groth16_setup", lambda cc, seed=0, progress=None: ref.jpk)
    JS.groth16_setup_cached(ref.jcc, seed=9, cache_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"{key}.chunked", f"{key}.pkl"]
    # a changed circuit misses
    other = toy(TCS, const=4)
    assert setup_cache_key(other, 9) != key
    pk2 = groth16_setup_cached(other, seed=9, cache_dir=str(tmp_path), device="cpu")
    assert len(list(tmp_path.glob("*.chunked"))) == 2
    assert [_g1(p) for p in pk2.vk.ic] != [_g1(p) for p in pk.vk.ic]
    assert_keys_equal(groth16_setup_cached(ref.cc, seed=9, device="cpu"), pk)  # no cache_dir


def test_entry_points_default_to_cuda(ref, tmp_path):
    """Without CUDA, every loader raises unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    TA.export_chunked(ref.pk, str(tmp_path), name="toy")
    for call in (lambda: TA.load_chunked(str(tmp_path), name="toy"),
                 lambda: TZ.read_zkey(ref.zkey),
                 lambda: groth16_setup_cached(ref.cc, seed=9, cache_dir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
