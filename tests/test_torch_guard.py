"""Guards of the port's two rules: it stands alone, and it runs on the card
unless told otherwise.

* No module under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or anything of ``repro`` (checked on the source, by AST).
* The entry points that create data raise when no ``device`` is given and
  no CUDA device exists, instead of returning CPU tensors.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.laq import Table
from repro_torch.data import generate_ssb, generate_star
from repro_torch.device import resolve_device
from repro_torch.interop import table_from_arrays

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/core/query/compile.py" in names
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import numpy\nfrom repro.core import laq\n"
                   "def f():\n    import jax.numpy as jnp\n")
    assert [m for m, _ in _imported_roots(src)] == ["numpy", "repro", "jax"]


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    """Here, with no card, omitting ``device`` must raise; the CPU is only
    ever chosen explicitly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = {"k": np.arange(4), "x": np.ones(4, np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Table.from_columns("t", cols, key_cols=("k",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_ssb(sf=1, scale=0.0005, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_star(1, 1, 6, scale=0.001)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table_from_arrays("t", ("x",), np.ones((4, 1)), {}, 4)
    t = Table.from_columns("t", cols, key_cols=("k",), device="cpu")
    assert t.matrix.device.type == "cpu" and t.key("k").dtype == torch.int32


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
