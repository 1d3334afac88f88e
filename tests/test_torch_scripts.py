"""The port's tool scripts on the CPU: msm_stress and prim_bench run end to
end at tiny sizes and print the JSON keys of the JAX package's scripts
(read from their source: their JAX programs take minutes to compile on a
CPU), and r1cs_info reports what the JAX package's reports on the same
circuits. Tolerance: exact equality."""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zkemail_tpu.circuits.builder import ConstraintSystem as JCS
from zkemail_tpu.scripts import msm_stress as JMS
from zkemail_tpu.scripts import prim_bench as JPB
from zkemail_tpu.scripts import r1cs_info as JRI
from zkemail_tpu_torch.circuits.builder import ConstraintSystem as TCS
from zkemail_tpu_torch.core import curve_torch as CT
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.curve import G1
from zkemail_tpu_torch.ops.msm import msm_multi, points_from_affine_ints
from zkemail_tpu_torch.scripts import msm_stress, prim_bench, r1cs_info

torch.set_num_threads(1)


def _dict_keys(node) -> dict:
    """The string keys of a dict literal, nested dict literals as sub-dicts."""
    return {k.value: _dict_keys(v) if isinstance(v, ast.Dict) else None
            for k, v in zip(node.keys, node.values)}


def _jax_msm_stress_keys() -> dict:
    tree = ast.parse(Path(JMS.__file__).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return _dict_keys(node.args[0])
    raise AssertionError("no json.dumps of a dict literal in the JAX msm_stress")


def _jax_prim_bench_keys() -> tuple:
    src = Path(JPB.__file__).read_text()
    names = []
    for is_f, name in re.findall(r'bench\(\s*(f?)"([^"]+)"', src):
        names += [name.format(k=k) for k in (1 << 14, 1 << 17)] if is_f else [name]
    entry = next(_dict_keys(n.value) for n in ast.walk(ast.parse(src))
                 if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                 and isinstance(n.targets[0], ast.Subscript))
    return sorted(dict.fromkeys(names)), entry


def _shape(obj):
    return {k: _shape(v) if isinstance(v, dict) else None for k, v in obj.items()}


@pytest.mark.parametrize("args", [
    ["--algo", "bucket", "--cbits", "4", "--threads", "2", "--n", "8", "--batch", "2"],
    ["--algo", "sort", "--n", "8", "--batch", "1"],
])
def test_msm_stress_runs_with_the_jax_keys(args, capsys):
    line = msm_stress.main(["--device", "cpu", "--reps", "1", *args])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert _shape(line) == _jax_msm_stress_keys()
    assert line["metric"] == "msm_stress_s" and line["value"] == min(line["detail"]["times"])
    assert line["detail"]["n"] == 8


def test_prim_bench_runs_with_the_jax_keys(capsys):
    out = prim_bench.main(["--device", "cpu", "--n", "64", "--reps", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    names, entry = _jax_prim_bench_keys()
    assert sorted(out) == names and len(names) == 14
    assert all(_shape(v) == entry for v in out.values())
    assert all(v["s"] > 0 for v in out.values())


def test_msm_multi_window_and_thread_options():
    """msm_multi(c_bits=, threads=), which msm_stress's --cbits and
    --threads reach, gives the reference sum."""
    rng = np.random.default_rng(4)
    ks = [int(k) for k in rng.integers(1, 10**6, size=6)]
    scal = [[int(s) for s in rng.integers(0, 1 << 40, size=6)] for _ in range(2)]
    pts_py = [G1.generator().mul(k) for k in ks]
    pts = points_from_affine_ints(CT.FQ_OPS, [p.x for p in pts_py], [p.y for p in pts_py])
    s = torch.from_numpy(LB.ints_to_limbs(scal))
    for c_bits, threads in ((4, 2), (5, 3)):
        aff = CT.ec_to_affine(CT.FQ_OPS, msm_multi(CT.FQ_OPS, pts, s, c_bits=c_bits,
                                                   threads=threads))
        xs = CT.FQ_OPS.to_ints(aff["x"])
        for b in range(2):
            want = G1.identity()
            for p, v in zip(pts_py, scal[b]):
                want = want.add(p.mul(v))
            assert int(xs[b]) == want.x, (c_bits, threads)


def _nested(cs_cls):
    """A circuit with nested and repeated scopes and unlabeled constraints."""
    cs = cs_cls("scopes")
    x = cs.add_input("x", ())
    y = cs.mul(x, x)
    with cs.scope("outer"):
        y = cs.mul(y, x)
        with cs.scope("inner"):
            y = cs.mul(y, y)
            with cs.scope("deep"):
                y = cs.mul(y, x)
        with cs.scope("inner2"):
            y = cs.mul(y, y)
    with cs.scope("outer"):
        y = cs.mul(y, x)
    cs.mark_public(cs.define(y + 1))
    return cs.compile()


def test_scope_report_equals_jax():
    rows = r1cs_info.scope_report(_nested(TCS))
    assert rows == JRI.scope_report(_nested(JCS))
    assert {r["scope"] for r in rows} >= {"outer/inner/deep", "(unlabeled)"}


def test_r1cs_info_nobody448_equals_jax(capsys):
    outs = []
    for mod in (JRI, r1cs_info):
        mod.main(["--config", "nobody448", "--json"])
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert outs[1]["n_constraints"] > 0 and len(outs[1]["scopes"]) > 1
    assert r1cs_info.CONFIGS == JRI.CONFIGS
