"""The benchmark's own tests: ``python -m pytest laqbench/tests``.

Tests marked ``cuda`` need the card and skip on a machine without one;
each decides inside the test.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips on a machine without")
