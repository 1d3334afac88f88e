"""Verifier codegen CLI — the rust verifier's `main.rs` re-done for the C++
native verifier.

The port of ``zkemail_tpu/native/codegen.py``, with the same flags and
output. Mirrors zk-email-verify packages/rust-verifier/src/main.rs:
  * ``generate-verifier`` (main.rs:47-80): snarkjs vkey.json -> a standalone
    C++ source with the vkey embedded (both our flat-affine layout used by
    ``groth16_verifier.cpp`` and the ark-compressed bytes for
    interoperability) plus nPublic baked in.  Compile with
    ``g++ -O2 -std=c++17 <out>.cpp -o verifier`` (no dependencies).
  * ``generate-verifier-arguments`` (main.rs:81-104): snarkjs proof.json +
    public.json -> ark-compressed proof / public-input bytes, printed as
    Rust-style byte arrays exactly like the reference, and optionally written
    as .bin files.

Usage:
  python -m zkemail_tpu_torch.native.codegen generate-verifier \
      --verifying-key vkey.json --output my_verifier.cpp
  python -m zkemail_tpu_torch.native.codegen generate-verifier-arguments \
      --proof proof.json --inputs public.json [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..prover.containers import Proof, VerifyingKey
from ..utils.ark_serialize import encode_proof, encode_publics, encode_vkey
from .verifier import proof_bytes, publics_bytes, vk_bytes

_DIR = Path(__file__).resolve().parent


def _c_array(name: str, data: bytes) -> str:
    body = ",".join(str(b) for b in data)
    return f"static const unsigned char {name}[{len(data)}] = {{{body}}};"


_TEMPLATE = """\
// Generated by zkemail_tpu_torch.native.codegen — standalone Groth16 verifier with
// an embedded verifying key (nPublic = {n_public}).
// Build: g++ -O2 -std=c++17 {out_name} -o verifier
// Run:   ./verifier <proof.bin> <publics.bin>   (flat-affine layout: proof =
//        a.x|a.y|b.x0|b.x1|b.y0|b.y1|c.x|c.y as 32-byte LE; publics = n*32 LE)
#define ZKEMAIL_NO_MAIN 1
{verifier_core}

{vk_array}
// ark-compressed vkey (serialize_compressed layout), for interop tooling:
{vk_ark_array}

extern "C" int verify(const unsigned char *proof_bytes,
                      const unsigned char *publics_bytes) {{
  return groth16_verify(EMBEDDED_VK, {n_ic}, proof_bytes, publics_bytes,
                        {n_public});
}}

#include <cstdio>
#include <cstdlib>
int main(int argc, char **argv) {{
  if (argc != 3) {{
    std::fprintf(stderr, "usage: %s <proof.bin> <publics.bin>\\n", argv[0]);
    return 2;
  }}
  auto slurp = [](const char *path, size_t want, std::vector<unsigned char> &buf) {{
    FILE *f = std::fopen(path, "rb");
    if (!f) {{ std::perror(path); std::exit(2); }}
    buf.resize(want);
    size_t got = std::fread(buf.data(), 1, want, f);
    std::fclose(f);
    if (got != want) {{
      std::fprintf(stderr, "%s: expected %zu bytes, got %zu\\n", path, want, got);
      std::exit(2);
    }}
  }};
  std::vector<unsigned char> proof, publics;
  slurp(argv[1], 256, proof);
  slurp(argv[2], (size_t){n_public} * 32, publics);
  int ok = verify(proof.data(), publics.data());
  std::printf(ok == 1 ? "OK\\n" : "INVALID\\n");
  return ok == 1 ? 0 : 1;
}}
"""


def generate_verifier(vkey_path: str, output: str) -> None:
    obj = json.loads(Path(vkey_path).read_text())
    vk = VerifyingKey.from_snarkjs(obj)
    n_public = int(obj.get("nPublic", len(vk.ic) - 1))
    core = (_DIR / "groth16_verifier.cpp").read_text()
    # inline the constants header so the generated file is self-contained
    core = core.replace(
        '#include "bn254_constants.h"',
        (_DIR / "bn254_constants.h").read_text().replace("#pragma once", ""),
    )
    out = _TEMPLATE.format(
        n_public=n_public,
        n_ic=len(vk.ic),
        out_name=Path(output).name,
        verifier_core=core,
        vk_array=_c_array("EMBEDDED_VK", vk_bytes(vk)),
        vk_ark_array=_c_array("EMBEDDED_VK_ARK_COMPRESSED", encode_vkey(vk)),
    )
    Path(output).write_text(out)
    print(f"wrote {output} (nPublic={n_public}, {len(vk.ic)} IC points)")


def generate_verifier_arguments(proof_path: str, inputs_path: str,
                                out_dir: str | None = None) -> None:
    proof = Proof.from_snarkjs(json.loads(Path(proof_path).read_text()))
    publics = [int(x) for x in json.loads(Path(inputs_path).read_text())]
    ser_proof = encode_proof(proof)
    ser_publics = encode_publics(publics)
    # write artifacts BEFORE printing: stdout may be a closed pipe (e.g.
    # `| head`) and must not abort the file outputs
    if out_dir:
        d = Path(out_dir)
        d.mkdir(parents=True, exist_ok=True)
        (d / "proof.bin").write_bytes(ser_proof)
        (d / "publics.bin").write_bytes(ser_publics)
        # flat-affine layout consumed by the generated C++ main()
        (d / "proof.flat.bin").write_bytes(proof_bytes(proof))
        (d / "publics.flat.bin").write_bytes(publics_bytes(publics))
    # same stdout format as main.rs:102-103
    try:
        print(f"PROOF: {list(ser_proof)}\n")
        print(f"PUBLIC_INPUTS: {list(ser_publics)}")
    except BrokenPipeError:
        pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="zkemail-tpu-verifier-codegen")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate-verifier")
    g.add_argument("--verifying-key", "-v", required=True)
    g.add_argument("--output", "-o", required=True)
    a = sub.add_parser("generate-verifier-arguments")
    a.add_argument("--proof", "-p", required=True)
    a.add_argument("--inputs", "-i", required=True)
    a.add_argument("--out-dir", default=None)
    ns = ap.parse_args(argv)
    if ns.cmd == "generate-verifier":
        generate_verifier(ns.verifying_key, ns.output)
    else:
        generate_verifier_arguments(ns.proof, ns.inputs, ns.out_dir)


if __name__ == "__main__":
    main()
