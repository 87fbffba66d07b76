"""The plain reference equals the port on the CPU for every frozen query
spec, at a small scale, and the bfloat16 control does not."""
import numpy as np
import pytest
import torch

from laqbench import gen, judge, models, program, spec
from laqbench.reference import answer

QUERIES = sorted(p.stem for p in (spec.HERE / "queries").glob("*.json"))
CONFIG = {"Q": "ssb-sf10", "P": "ssb-sf10", "S": "synth-s1-sf8"}
SCALE = {"ssb-sf10": 0.002, "synth-s1-sf8": 0.002}


def _case(name, seed=5):
    qspec = spec.load("queries", name)
    cfg = spec.load("configs", CONFIG[name[0]])
    raw = gen.generate(cfg, seed, "cpu", SCALE[cfg["name"]])
    drawn = (models.draw(qspec["model"], sum(spec.feature_counts(qspec)))
             if qspec["model"] else None)
    return qspec, raw, drawn


@pytest.mark.parametrize("name", QUERIES)
def test_reference_equals_port(name):
    qspec, raw, drawn = _case(name)
    plans, _ = program.compile_all(program.tables(gen.to_host(raw), "cpu"),
                                   {name: qspec},
                                   {name: drawn} if drawn else {},
                                   torch.device("cpu"))
    out = {k: v.numpy() for k, v in plans[name].run().items()}
    want = answer(raw, qspec, drawn)
    rows_ok, groups_ok, gaps = judge.compare(out, want, qspec)
    assert rows_ok and groups_ok
    assert gaps.get("sum_gap", 0.0) <= 1e-6, gaps
    assert gaps.get("leaf_count_gap", 0.0) == 0.0, gaps   # exact counts
    tree = qspec["model"] is not None and qspec["model"]["kind"] == "tree"
    assert ("leaf_count_gap" in gaps) == tree


def test_ssb_tables_have_every_column_of_ssb():
    cfg = spec.load("configs", "ssb-sf10")
    raw = gen.generate(cfg, 3, "cpu", 0.0005)
    widths = {name: len(rt.columns) for name, rt in raw.items()}
    assert widths == {"lineorder": 17, "part": 9, "supplier": 7,
                      "customer": 8, "date": 17}
    assert {n: list(rt.columns) for n, rt in raw.items()} == cfg["schema"]
    d = {c: t.numpy() for c, t in raw["date"].columns.items()}
    assert d["datekey"].shape == (2556,)            # 1992-01-01..1998-12-30
    leap = (d["d_month"] == 2) & (d["d_daynuminmonth"] == 29)
    assert sorted(d["d_year"][leap]) == [1992, 1996]
    assert (d["d_year"][-1], d["d_month"][-1],
            d["d_daynuminmonth"][-1]) == (1998, 12, 30)
    assert d["d_dayofweek"][0] == 3                 # a Wednesday
    assert set(np.bincount(d["d_year"] - 1992)) == {366, 365, 364}
    assert d["d_weeknuminyear"].max() == 53
    floats = {c for c, t in raw["lineorder"].columns.items()
              if t.is_floating_point()}
    assert set(raw["lineorder"].keys) == set(raw["lineorder"].columns) - floats


def test_tables_are_built_by_the_programs_constructor(monkeypatch):
    from repro_torch.core.laq import Table
    calls = []
    real = Table.from_columns

    def spy(name, cols, **kw):
        calls.append((name, tuple(cols), kw.get("key_cols")))
        return real(name, cols, **kw)
    monkeypatch.setattr(Table, "from_columns", staticmethod(spy))
    raw = gen.generate(spec.load("configs", "ssb-sf10"), 3, "cpu", 0.0005)
    tables = program.tables(gen.to_host(raw), "cpu")
    assert [c[0] for c in calls] == list(raw)
    lo = tables["lineorder"]
    assert lo.columns == tuple(raw["lineorder"].columns)
    assert torch.equal(lo.col("lo_revenue"),
                       raw["lineorder"].columns["lo_revenue"])


def test_reference_sees_rows():
    # The scale keeps every query group non-empty somewhere, so the
    # equality above is not one of empty answers.
    total = {n: answer(*_case(n)[1:2], spec.load("queries", n),
                       _case(n)[2]).rows for n in ("Q1.1", "Q2.1", "Q3.1",
                                                   "Q4.1", "P1.linear.year")}
    assert all(r > 0 for r in total.values()), total


def test_control_is_not_the_reference():
    qspec, raw, drawn = _case("P1.linear.year")
    want = answer(raw, qspec, drawn)
    low = answer(raw, qspec, drawn, precision="bfloat16")
    gap = np.max(np.abs(low.sums["prediction"] - want.sums["prediction"])
                 / want.mass["prediction"])
    assert gap > 1e-4


def test_decode_inverts_row_major_codes():
    gb = [{"bound": 8, "offset": 1992}, {"bound": 1000}]
    keys = np.array([[1993, 7], [1998, 999]])
    codes = (keys[:, 0] - 1992) * 1000 + keys[:, 1]
    from laqbench.reference.answers import decode
    assert np.array_equal(decode(codes, gb), keys)
