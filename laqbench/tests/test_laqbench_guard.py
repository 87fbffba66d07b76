"""No module the harness or the reference loads is JAX's or the JAX
package's, by source and by ``sys.modules`` after a run; the reference,
the generators and the judge load nothing of the program either."""
import ast
import json
import subprocess
import sys

import pytest

from laqbench import harness, spec

HERE = spec.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "ml_dtypes", "repro"}
# Modules that must stay apart from the program (the yardstick).
APART = ["reference/answers.py", "reference/__init__.py", "gen/__init__.py",
         "gen/ssb.py", "gen/synthetic_star.py", "judge.py", "models.py",
         "roofline.py", "spec.py", "trace.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                yield ((node.module or "") + "." + a.name).strip("."), \
                    node.level


def test_forbidden_names_compare_whole_top_levels():
    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert "repro_torch" not in FORBIDDEN      # the port's name starts alike


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_jax_in_source(path):
    for name, level in _imports(HERE / path):
        if level == 0:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", APART)
def test_yardstick_imports_nothing_of_the_program(path):
    for name, level in _imports(HERE / path):
        top = name.split(".")[0]
        assert top != "repro_torch", (path, name)
        if level:
            assert top not in ("program", "harness", "run"), (path, name)
        else:
            assert name.split(".")[:2] not in (["laqbench", "program"],
                                               ["laqbench", "harness"])


def _modules_after(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_sys_modules_after_a_run():
    tops = _modules_after(
        "import sys, time, json; sys.path[:0] = ['src', '.']\n"
        "from laqbench import harness\n"
        "harness.run_cell('s1sf8.linear128', 9, 0.2, True, 'cpu',"
        " time.perf_counter(), scale=0.001)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" in tops          # the program did run
    assert not tops & FORBIDDEN


def test_sys_modules_of_the_reference_alone():
    tops = _modules_after(
        "import sys, json; sys.path[:0] = ['.']\n"
        "from laqbench import gen, judge, models, spec\n"
        "from laqbench.reference import answer\n"
        "q = spec.load('queries', 'P3.tree.year')\n"
        "raw = gen.generate(spec.load('configs', 'ssb-sf10'), 1, 'cpu',"
        " 0.0005)\n"
        "answer(raw, q, models.draw(q['model'], 5))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" not in tops
    assert not tops & FORBIDDEN
