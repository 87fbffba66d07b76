"""Guards of the port's rules: it stands alone, it runs on the card unless
told otherwise, and its tests leave the test process as they found it.

* No module under ``src/repro_torch/``, not ``chip_smoke.py`` and no
  ``scripts/torch_*.py`` imports ``jax``, ``ml_dtypes`` (the card machine
  has none) or anything of ``repro`` (checked on the source, by AST).
* The entry points that create data (tables, LM parameters, the serving
  and training drivers) raise when no ``device`` is given and no CUDA
  device exists, instead of returning CPU tensors.
* No port test (``tests/test_torch_*.py``, ``tests/torch_parity.py``)
  changes process-wide state — seeds, default dtypes, thread counts, JAX's
  config, the environment — or draws hypothesis examples (``@given``): the
  test run puts a whole file on one worker beside the reference's tests,
  so such a call could change what a later test sees, and a fresh draw
  could fail in one run and not the next (checked on the source, by AST).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.laq import Table
from repro_torch.core.query.workload import (check_case, generate_case,
                                             run_fuzz)
from repro_torch.data import generate_ssb, generate_star
from repro_torch.device import resolve_device
from repro_torch.interop import table_from_arrays
from repro_torch.launch.serve import FusedFeatureServer, run_serving
from repro_torch.launch.train import train
from repro_torch.models import LM
from repro_torch.prng import PRNGKey

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
TEST_FILES = sorted((ROOT / "tests").glob("test_torch_*.py")) + [
    ROOT / "tests" / "torch_parity.py"]
#: Calls that change process-wide state (dotted as written in the source).
GLOBAL_STATE_CALLS = {
    "torch.manual_seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.seed", "torch.set_default_dtype",
    "torch.set_default_device", "torch.set_default_tensor_type",
    "torch.set_num_threads", "torch.set_num_interop_threads",
    "torch.use_deterministic_algorithms", "jax.config.update",
    "np.random.seed", "numpy.random.seed", "random.seed",
    "os.environ.update", "os.environ.setdefault", "os.environ.pop",
    "os.environ.clear", "os.putenv", "os.unsetenv"}


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
    for module in ("core/query/compile.py", "core/laq/catalog.py",
                   "core/query/multiquery.py", "core/query/scheduler.py",
                   "core/query/session.py", "data/ssb_queries.py",
                   "core/query/snowflake.py", "core/query/rewrite.py",
                   "core/query/workload.py", "core/query/streaming.py",
                   "core/laq/sort.py", "models/lm.py", "launch/serve.py",
                   "optim/adamw.py", "data/tokens.py", "checkpoint/manager.py",
                   "runtime/fault_tolerance.py", "launch/steps.py",
                   "launch/train.py"):
        assert f"src/repro_torch/{module}" in names, module
    assert all(p.exists() for p in PORT_FILES)


def _dotted(node) -> str:
    """``a.b.c`` for a Name/Attribute chain, else ""."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _global_state_uses(path: Path):
    """(what, line) for every global-state call, ``os.environ`` write and
    hypothesis ``@given`` in one file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in GLOBAL_STATE_CALLS:
                yield name, node.lineno
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, (ast.Assign,
                                                         ast.Delete))
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and _dotted(t.value) == "os.environ"):
                    yield "os.environ[...] write", node.lineno
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                fn = dec.func if isinstance(dec, ast.Call) else dec
                if _dotted(fn).split(".")[-1] == "given":
                    yield "@given", dec.lineno


@pytest.mark.parametrize("path", TEST_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_tests_leave_global_state(path):
    bad = list(_global_state_uses(path))
    assert not bad, (f"{path.relative_to(ROOT)}: "
                     + ", ".join(f"{what} at line {line}"
                                 for what, line in bad))


def test_global_state_scan_catches_each_kind(tmp_path):
    src = tmp_path / "test_x.py"
    src.write_text(
        "import os, torch, jax\n"
        "from hypothesis import given\n"
        "torch.manual_seed(0)\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "os.environ['X'] = '1'\n"
        "torch.set_num_threads(1)\n"
        "g = PRNGKey(0)\n"
        "@given(x=None)\n"
        "def test_a(x):\n    pass\n")
    assert sorted(_global_state_uses(src), key=lambda u: u[1]) == [
        ("torch.manual_seed", 3), ("jax.config.update", 4),
        ("os.environ[...] write", 5), ("torch.set_num_threads", 6),
        ("@given", 8)]


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


def test_entry_points_without_device_raise_when_no_card(monkeypatch,
                                                         tmp_path):
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_case(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_case(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fuzz(1)
    smoke = get_smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(smoke).init(PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedFeatureServer(setting=2, sf=1, k=6, l=2, scale=0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving("smollm-360m", batch=1, decode_steps=1, k=6, l=2,
                    repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("smollm-360m", smoke=True, steps=1, batch=2, seq=16,
              ckpt_dir=str(tmp_path), ckpt_every=1)
    assert generate_case(0, device="cpu").tables["fact"].device.type == "cpu"
    t = Table.from_columns("t", cols, key_cols=("k",), device="cpu")
    assert t.matrix.device.type == "cpu" and t.key("k").dtype == torch.int32


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
