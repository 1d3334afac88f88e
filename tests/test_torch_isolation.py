"""The port stands alone: no file of zkemail_tpu_torch/, nor chip_smoke.py,
imports jax, jaxlib, the JAX package or cryptography (the card machine has
none of them), and every port module (and chip_smoke) imports with those
names refused."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "zkemail_tpu", "cryptography"}


def _port_files():
    return sorted((ROOT / "zkemail_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_forbidden_imports_in_source():
    bad = []
    files = _port_files()
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path.name, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad


_REFUSING_IMPORT = """
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "zkemail_tpu", "cryptography"}:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import zkemail_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(zkemail_tpu_torch.__path__, "zkemail_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
assert not {"jax", "jaxlib", "zkemail_tpu", "cryptography"} & set(sys.modules)
print(len(mods))
"""


def test_port_imports_with_jax_refused():
    out = subprocess.run(
        [sys.executable, "-c", _REFUSING_IMPORT], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 53
