"""The PyTorch port stands alone: importing every module of
``spark_rapids_tpu_torch`` (and ``chip_smoke.py``) loads neither ``jax`` nor
``spark_rapids_tpu``, and no source of theirs or of the port's scripts on
the card (``*_kernel_ab.py``, ``nfa_match_limits.py``) imports either, nor
pandas (the card's machine has none)."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "spark_rapids_tpu_torch"


def _forbidden(module: str) -> bool:
    # "spark_rapids_tpu_torch" starts with "spark_rapids_tpu": match exactly
    return module == "jax" or module.startswith("jax.") \
        or module == "spark_rapids_tpu" \
        or module.startswith("spark_rapids_tpu.")


def _sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "decimal_kernel_ab.py",
                                 "nfa_match_limits.py",
                                 "parquet_kernel_ab.py")]


def test_import_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "spark_rapids_tpu_torch.session" in loaded
    assert "spark_rapids_tpu_torch.udf.kernels" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m) or m == "pandas"
            or m.startswith("pandas.")] == []
