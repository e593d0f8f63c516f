"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax``, ``ml_dtypes`` nor anything of the JAX package, and
``chip_smoke.py`` fails — printing no result — where there is no card or
no repository around it."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _run(code: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


def _top(name: str) -> str:
    return name.split(".")[0]


def test_port_sources_import_nothing_forbidden():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert _top(name) not in FORBIDDEN, f"{path}: imports {name}"


def test_import_leaves_no_jax_or_repro_in_sys_modules():
    code = (
        "import sys, importlib, pkgutil\n"
        "import repro_torch, repro_torch.serve_filter\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_chip_smoke_fails_without_a_card():
    res = _run(
        "import torch, runpy, sys\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_smoke.py']\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "is_available() is False" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "repro_torch" in res.stderr
