"""Nothing under proofbench/ imports JAX or the JAX package (top-level
names compared whole: zkemail_tpu_torch is the program), and the reference
imports nothing of the program either."""

import ast
from pathlib import Path

from proofbench import harness as H

FORBIDDEN = {"jax", "jaxlib", "flax", "zkemail_tpu"}


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(H.HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not top_level_imports(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((H.HERE / "reference").glob("*.py")):
        assert "zkemail_tpu_torch" not in top_level_imports(f), f
    for f in ("signer.py", "traffic.py", "roofline.py"):
        assert "zkemail_tpu_torch" not in top_level_imports(H.HERE / f), f


def test_the_run_checks_loaded_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "zkemail_tpu_torch_like", types.ModuleType("x"))
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "zkemail_tpu.core", types.ModuleType("x"))
    assert H.forbidden_modules() == ["zkemail_tpu"]
