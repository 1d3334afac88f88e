"""Chunked proving-key artifact store.

The port of ``zkemail_tpu/prover/artifacts.py``, in its format byte for
byte, so that files written by either package load in the other. The
reference ships its zkey as gzipped chunks with suffixes ``b``..``k``,
downloads them in parallel, and caches the uncompressed blobs client-side
(packages/helpers/src/chunked-zkey.ts:9-74). Here a ProvingKey is exported
as N gzipped chunks with the same suffix convention plus a JSON manifest
carrying shapes and SHA-256 integrity hashes; loading verifies every chunk
and puts the query tables straight onto the key's device.

Layout per chunk file ``<name>.pkchunk<suffix>.gz``: a raw slice of the
concatenated little-endian int32 stream of all query tables (the 12-bit
interchange limbs of the projective points, Montgomery form, R = 2^264).
The manifest ``<name>.manifest.json`` stores the table schema (field order,
shapes), the host points and the verifying key, and per-chunk digests.

Compression, decompression and hashing run on a thread pool, one chunk per
task (zlib and hashlib release the GIL), so a full640 key's 2.28 GB stream
is not squeezed through one core.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..core.curve import G1, G2
from ..core.towers import Fq2
from ..device import resolve_device
from .containers import VerifyingKey
from .setup import ProvingKey

# same suffix alphabet as chunked-zkey.ts:9 ("b" .. "k" = up to 10 chunks)
_SUFFIXES = "bcdefghijk"

# Manifest format version, the JAX package's: 3 is the CircomReduction H
# basis with n_constraints; older manifests would prove invalid proofs
# with no error if loaded.
_FORMAT_VERSION = 3

QUERIES = ("a_query", "b1_query", "b2_query", "c_query", "h_query")


def _g1_json(p: G1) -> list:
    return [str(p.x), str(p.y), int(p.inf)]


def _g1_from(obj) -> G1:
    return G1.identity() if obj[2] else G1(int(obj[0]), int(obj[1]))


def _g2_json(p: G2) -> list:
    if p.inf:
        return [["0", "0"], ["0", "0"], 1]
    return [[str(p.x.c0), str(p.x.c1)], [str(p.y.c0), str(p.y.c1)], 0]


def _g2_from(obj) -> G2:
    if obj[2]:
        return G2.identity()
    return G2(Fq2(int(obj[0][0]), int(obj[0][1])), Fq2(int(obj[1][0]), int(obj[1][1])))


def _tables(pk: ProvingKey):
    """(schema, [int32 tensors]) in the manifest's order: query by query,
    coordinates sorted, Fq2 components c0 then c1."""
    schema, parts = [], []
    for qname in QUERIES:
        q = getattr(pk, qname)
        for coord in sorted(q.keys()):
            v = q[coord]
            comps = [(ci, c) for ci, c in enumerate(v)] if isinstance(v, tuple) else [(-1, v)]
            for ci, c in comps:
                schema.append([qname, coord, ci, list(c.shape)])
                parts.append(c)
    return schema, parts


def _pool():
    return ThreadPoolExecutor(max_workers=min(len(_SUFFIXES), os.cpu_count() or 1))


def export_chunked(pk: ProvingKey, out_dir: str, name: str = "emailverifier",
                   n_chunks: int = 10) -> dict:
    """Write <name>.pkchunk{b..}.gz + <name>.manifest.json; returns the
    manifest (the JAX package's, for the same key)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    schema, parts = _tables(pk)
    host = torch.empty(sum(p.numel() for p in parts), dtype=torch.int32)
    off = 0
    for p in parts:  # each table straight into its place in the stream
        host[off : off + p.numel()].copy_(p.reshape(-1))
        off += p.numel()
    raw = memoryview(host.numpy()).cast("B")
    n_chunks = max(1, min(n_chunks, len(_SUFFIXES)))
    chunk_len = -(-len(raw) // n_chunks)

    def write(i: int) -> dict:
        blob = raw[i * chunk_len : (i + 1) * chunk_len]
        fname = f"{name}.pkchunk{_SUFFIXES[i]}.gz"
        with gzip.open(out / fname, "wb", compresslevel=1) as f:
            f.write(blob)
        return {"file": fname, "bytes": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}

    with _pool() as pool:
        chunks = list(pool.map(write, range(n_chunks)))
    manifest = {
        "format_version": _FORMAT_VERSION,
        "name": name,
        "domain_log2": pk.domain_log2,
        "n_public": pk.n_public,
        "n_constraints": pk.n_constraints,
        "schema": schema,
        "chunks": chunks,
        "host_points": {
            "alpha_g1": _g1_json(pk.alpha_g1),
            "beta_g1": _g1_json(pk.beta_g1),
            "beta_g2": _g2_json(pk.beta_g2),
            "delta_g1": _g1_json(pk.delta_g1),
            "delta_g2": _g2_json(pk.delta_g2),
        },
        "vk": {
            "alpha_g1": _g1_json(pk.vk.alpha_g1),
            "beta_g2": _g2_json(pk.vk.beta_g2),
            "gamma_g2": _g2_json(pk.vk.gamma_g2),
            "delta_g2": _g2_json(pk.vk.delta_g2),
            "ic": [_g1_json(p) for p in pk.vk.ic],
        },
    }
    (out / f"{name}.manifest.json").write_text(json.dumps(manifest))
    return manifest


def load_chunked(out_dir: str, name: str = "emailverifier", device=None) -> ProvingKey:
    """Load and integrity-check the chunks, rebuild the ProvingKey with its
    query tables on `device` (default: CUDA) and an empty cache: the
    prover rebuilds its signal plan on first use."""
    dev = resolve_device(device)
    out = Path(out_dir)
    manifest = json.loads((out / f"{name}.manifest.json").read_text())
    ver = manifest.get("format_version")
    if ver != _FORMAT_VERSION or "n_constraints" not in manifest:
        # a stale export: an old-basis h_query silently yields invalid proofs
        raise ValueError(
            f"chunked artifact '{name}' has format_version={ver!r} "
            f"(need {_FORMAT_VERSION} with n_constraints); re-export with "
            "export_chunked"
        )
    chunks = manifest["chunks"]
    total = sum(int(ch["bytes"]) for ch in chunks)
    stream = np.empty(total + (-total) % 4, dtype=np.uint8)
    offsets = np.cumsum([0] + [int(ch["bytes"]) for ch in chunks])

    def read(i: int) -> None:
        ch = chunks[i]
        with gzip.open(out / ch["file"], "rb") as f:
            blob = f.read()
        if hashlib.sha256(blob).hexdigest() != ch["sha256"]:
            raise ValueError(f"integrity check failed for {ch['file']}")
        if len(blob) != ch["bytes"]:
            raise ValueError(f"size mismatch for {ch['file']}")
        stream[offsets[i] : offsets[i + 1]] = np.frombuffer(blob, dtype=np.uint8)

    with _pool() as pool:
        list(pool.map(read, range(len(chunks))))
    if total % 4:
        raise ValueError("trailing data in chunk stream")
    words = stream.view(np.int32)
    queries = {q: {} for q in QUERIES}
    off = 0
    for qname, coord, ci, shape in manifest["schema"]:
        size = int(np.prod(shape))
        if off + size > len(words):
            raise ValueError("chunk stream shorter than its schema")
        arr = torch.from_numpy(words[off : off + size].reshape(shape)).to(dev)
        off += size
        if ci == -1:
            queries[qname][coord] = arr
        else:
            queries[qname].setdefault(coord, [None, None])[ci] = arr
    if off != len(words):
        raise ValueError("trailing data in chunk stream")
    for q in queries.values():
        for k, v in list(q.items()):
            if isinstance(v, list):
                q[k] = tuple(v)
    hp = manifest["host_points"]
    vk = manifest["vk"]
    return ProvingKey(
        domain_log2=manifest["domain_log2"],
        n_public=manifest["n_public"],
        n_constraints=manifest["n_constraints"],
        alpha_g1=_g1_from(hp["alpha_g1"]),
        beta_g1=_g1_from(hp["beta_g1"]),
        beta_g2=_g2_from(hp["beta_g2"]),
        delta_g1=_g1_from(hp["delta_g1"]),
        delta_g2=_g2_from(hp["delta_g2"]),
        vk=VerifyingKey(
            alpha_g1=_g1_from(vk["alpha_g1"]),
            beta_g2=_g2_from(vk["beta_g2"]),
            gamma_g2=_g2_from(vk["gamma_g2"]),
            delta_g2=_g2_from(vk["delta_g2"]),
            ic=[_g1_from(p) for p in vk["ic"]],
        ),
        device=dev,
        **queries,
    )


def download_chunked(base_url: str, cache_dir: str, name: str = "emailverifier",
                     retries: int = 3, fetch=None, progress=None,
                     device=None) -> ProvingKey:
    """Fetch manifest + chunks into cache_dir (with per-chunk retries), then
    load_chunked onto `device`.

    Parity: chunked-zkey.ts downloadFromFilename/downloadProofFiles — each
    compressed chunk is fetched with up to `retries` attempts (:24-33),
    integrity-checked, and cached so later calls skip the network (:35-56,
    localforage role played by the on-disk cache_dir). `fetch(url) -> bytes`
    is injectable for tests and custom transports; default urllib.
    """
    def default_fetch(url: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.read()

    fetch = fetch or default_fetch
    cache = Path(cache_dir)
    cache.mkdir(parents=True, exist_ok=True)

    def fetch_with_retry(fname: str) -> bytes:
        last = None
        for attempt in range(retries):
            try:
                data = fetch(f"{base_url.rstrip('/')}/{fname}")
                if progress:
                    progress(f"downloaded {fname} ({len(data)} bytes)")
                return data
            except Exception as exc:  # noqa: BLE001 — retry any transport error
                last = exc
                if progress:
                    progress(f"attempt {attempt + 1}/{retries} failed for {fname}: {exc}")
        raise RuntimeError(f"failed to fetch {fname} after {retries} attempts") from last

    man_name = f"{name}.manifest.json"
    man_path = cache / man_name
    if not man_path.exists():
        man_path.write_bytes(fetch_with_retry(man_name))
    manifest = json.loads(man_path.read_text())
    for ch in manifest["chunks"]:
        path = cache / ch["file"]
        if path.exists():
            with gzip.open(path, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() == ch["sha256"]:
                    continue  # cached + intact
        path.write_bytes(fetch_with_retry(ch["file"]))
    return load_chunked(str(cache), name, device=device)
