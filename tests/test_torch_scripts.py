"""The port's two command lines on the CPU, against the reference's.

* ``scripts/torch_fuzz_repro.py`` (``main([... "--device", "cpu"])``):
  ``--seed`` replays one flat and one chained seed with exit 0, printing
  the reference script's description of the same seed line for line;
  ``--seed N --rewrite-matrix`` and a 3-case campaign exit 0;
  ``--rewrite-matrix`` without ``--seed`` is the reference's usage error
  (exit 2).
* ``scripts/torch_memcap_proof.py``'s ``run_mode("stream")`` (a memory
  budget that cuts the fact into four chunks, so the plan streams) and
  ``run_mode("incore")`` at 200,000 rows, uncapped: both give the same
  outputs (their digest) and the reference's checksum on the same seeded
  star within rtol 1e-6.  No capped child runs here: the card's
  device-memory proof runs in ``chip_smoke.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
#: The first flat and the first chained seed of the fuzzer (as
#: ``chip_smoke.FUZZ_FLAT``/``FUZZ_CHAINED`` list them).
FLAT_SEED, CHAINED_SEED = 2, 0
MEMCAP_ROWS = 200_000
#: A budget that cuts the 200,000-row fact into four chunks.
MEMCAP_BUDGET_MB = 10


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fuzz():
    return _script("torch_fuzz_repro")


@pytest.fixture(scope="module")
def memcap():
    return _script("torch_memcap_proof")


@pytest.mark.parametrize("seed", (FLAT_SEED, CHAINED_SEED))
def test_fuzz_replay_prints_the_reference_description(fuzz, seed, capsys):
    from repro.core.query.workload import generate_case as ref_case
    from repro_torch.core.query.workload import generate_case
    ref = _script("fuzz_repro")
    want = ref._describe(ref_case(seed))
    assert fuzz._describe(generate_case(seed, device="cpu")) == want
    assert fuzz.main(["--seed", str(seed), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(want + "\n")
    assert f"OK: seed {seed} bit-exact across the full matrix" in out
    assert out.splitlines()[-1] == ('[launches] {"fused_star_gather": 0, '
                                    '"tree_predict": 0, "onehot_matmul": 0}')
    assert (any(a.links for a in ref_case(seed).query.arms)
            == (seed == CHAINED_SEED))


@pytest.mark.parametrize("seed", (FLAT_SEED, CHAINED_SEED))
def test_fuzz_rewrite_matrix(fuzz, seed, capsys):
    assert fuzz.main(["--seed", str(seed), "--rewrite-matrix",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rewrite trail:" in out
    assert f"OK: seed {seed} rewrite on == off == oracle" in out


def test_fuzz_campaign_and_usage_error(fuzz, capsys):
    assert fuzz.main(["--cases", "3", "--device", "cpu"]) == 0
    assert "fuzz: 3 cases, 0 mismatches" in capsys.readouterr().out
    with pytest.raises(SystemExit) as err:
        fuzz.main(["--cases", "3", "--rewrite-matrix", "--device", "cpu"])
    assert err.value.code == 2
    assert "--rewrite-matrix requires --seed" in capsys.readouterr().err


def _ref_checksum(rows: int) -> float:
    """The reference's streamed ``run_mode`` checksum, unrounded."""
    from repro.core.query import compile_query
    ref = _script("memcap_proof")
    plan = compile_query(ref.build_catalog(rows), ref.the_query(),
                         memory_budget_bytes=MEMCAP_BUDGET_MB << 20)
    assert plan._stream is not None
    return float(np.sum(np.asarray(plan.run()["pred"], np.float64)))


def test_memcap_modes_agree_with_each_other_and_the_reference(memcap,
                                                             capsys):
    stream = memcap.run_mode("stream", MEMCAP_ROWS, MEMCAP_BUDGET_MB, "cpu")
    out = capsys.readouterr().out
    assert "[memcap] stream: stream: 4 chunk(s)" in out
    incore = memcap.run_mode("incore", MEMCAP_ROWS, MEMCAP_BUDGET_MB, "cpu")
    assert stream["digest"] == incore["digest"]
    assert stream["checksum"] == incore["checksum"]
    assert stream["n"] == incore["n"] > 0
    assert stream["peak_bytes"] is None
    np.testing.assert_allclose(stream["checksum"],
                               _ref_checksum(MEMCAP_ROWS), rtol=1e-6)
