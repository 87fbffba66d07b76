"""Randomized snowflake workloads fuzzing the compiler against numpy (port of
``repro.core.query.workload``).

The compiler leans on algebraic identities — factored joins compose
associatively, predicates fold into validity vectors, Eq. 1 prefusion
distributes over arms — and hand-written tests only exercise the schemas
their authors thought of.  This module generates *random* snowflake schemas
(chain depth ≤ 3, fanout ≤ 3 per node), random predicates (up to two per
column, strict and non-strict bounds mixed so the rewrite engine's interval
merging is exercised), models, prediction filters (``model_preds``) and
aggregate sets, runs them end to end through :func:`compile_query` across
fused/nonfused × segment/matmul, and checks the results **bit for bit**
against an independent float64 numpy oracle.  The full matrix also runs
with ``rewrite="off"`` (on and off must agree bit for bit), streams the
fact axis in 16-row chunks (``stream_chunk_rows=16``), appends rows and
re-checks a session's refresh against a cold compile, and serves FK
request batches through :func:`compile_serving`.

Bit-exactness is by construction, not tolerance: every generated column is
integer-valued in a small range, model weights and tree thresholds are small
integers and row counts are bounded, so each float32 sum and product the
engine computes is exact and equals the float64 oracle's value (``div``
value expressions are excluded for that reason; ``mean`` is checked through
a float32 division of the exact sum/count pair, as the engine lowers it).
A mismatch is therefore a compiler fault, never rounding.  The same holds
for the streamed leg on every device: the card's atomic adds of integer
values are exact in any order.

Every case derives from one integer seed: ``generate_case(seed)`` draws the
same numbers, in the same order, as the reference's, so one seed gives the
same tables, query and oracle in both packages.  The tables are built on
the card unless ``device`` says otherwise; model heads stay on the host and
move to the tables' device when compiled.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ..fusion.operators import LinearOperator, tree_from_arrays
from ..laq.catalog import Catalog
from ..laq.selection import Pred
from ..laq.table import PAD_KEY, Table
from .compile import compile_query
from .ir import (COUNT_STAR, PREDICTION, Aggregate, ArmSpec, ChainLink,
                 GroupKey, PredictionFilter, PredictiveQuery)
from .serving import compile_serving, requests_from_rows
from .session import Session

#: Chain shape bounds.
MAX_DEPTH = 3        # head + up to 2 further hops
MAX_FANOUT = 3       # children per chain node
MAX_LINKS = 4        # total sub-dimensions per arm

#: Canonical capacities (the reference's, so the draws match).
_FACT_CAPS = (64, 128)
_DIM_CAPS = (16, 32)

_BACKENDS = ("fused", "nonfused")
_AGG_BACKENDS = ("segment", "matmul")

_CMP = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge}


def _host(x) -> np.ndarray:
    """numpy view of a tensor (copied off the device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# Schema + data generation
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FuzzCase:
    """One generated workload: tables + query, fully derived from ``seed``."""

    seed: int
    tables: Dict[str, Table]
    query: PredictiveQuery

    def catalog(self) -> Catalog:
        """A fresh mutable catalog over the case tables."""
        return Catalog(dict(self.tables))


def _make_table(rng: np.random.Generator, name: str, n: int, cap: int,
                key_data: Dict[str, np.ndarray],
                val_cols: Sequence[str], dev: torch.device) -> Table:
    """An integer-valued Table: key columns + small feature/measure columns.

    Key columns are mirrored into the matrix, padded with ``PAD_KEY``
    beyond the live rows; value columns draw from [-4, 4].
    """
    data = dict(key_data)
    for c in val_cols:
        data[c] = rng.integers(-4, 5, n)
    cols = tuple(data)
    matrix = np.zeros((cap, len(cols)), np.float32)
    for j, c in enumerate(cols):
        matrix[:n, j] = data[c]
    keys = {}
    for c in key_data:
        a = np.full(cap, PAD_KEY, np.int32)
        a[:n] = np.asarray(key_data[c], np.int32)
        keys[c] = torch.from_numpy(a).to(dev)
    return Table(name, cols, torch.from_numpy(matrix).to(dev), keys, n)


def _rand_pred(rng: np.random.Generator, col: str) -> Pred:
    op = rng.choice(["==", ">", ">=", "<", "<=", "between", "in"])
    if op == "between":
        lo = int(rng.integers(-4, 2))
        return Pred(col, "between", (lo, lo + int(rng.integers(1, 5))))
    if op == "in":
        vals = sorted(int(v) for v in rng.choice(
            np.arange(-4, 5), size=int(rng.integers(2, 5)), replace=False))
        return Pred(col, "in", tuple(vals))
    return Pred(col, str(op), int(rng.integers(-3, 4)))


def _rand_preds(rng: np.random.Generator, col: str) -> Tuple[Pred, ...]:
    """1–2 predicates on the *same* column: stacked strict/non-strict
    bounds exercise the rewrite engine's interval merging."""
    preds = [_rand_pred(rng, col)]
    if rng.random() < 0.4:
        preds.append(_rand_pred(rng, col))
    return tuple(preds)


def _gen_dim_tree(rng: np.random.Generator, arm_id: int
                  ) -> Tuple[List[dict], List[ChainLink]]:
    """One arm's dimension tree: head spec + ChainLinks (depth/fanout caps).

    Each spec dict carries ``name / n / cap / nfeat / children``; tables
    are built afterwards so parents can carry FK columns to every child.
    """
    counter = [0]

    def new_spec(depth: int) -> dict:
        counter[0] += 1
        name = f"a{arm_id}d{counter[0]}"
        spec = {"name": name, "n": int(rng.integers(4, 17)),
                "cap": int(rng.choice(_DIM_CAPS)),
                "nfeat": int(rng.integers(0, 3)), "children": []}
        if depth < MAX_DEPTH:
            for _ in range(int(rng.integers(0, MAX_FANOUT + 1))):
                if counter[0] > MAX_LINKS:
                    break
                if rng.random() < 0.45:
                    spec["children"].append(new_spec(depth + 1))
        return spec

    head = new_spec(1)
    links: List[ChainLink] = []

    def flatten(spec: dict, is_head: bool):
        for i, child in enumerate(spec["children"]):
            # parent=None exercises the previous-hop default, but only
            # where declaration order makes the previous hop THE parent:
            # the first child declared right after its parent.
            explicit = not (i == 0 and (is_head or rng.random() < 0.5))
            preds = ()
            if rng.random() < 0.35 and child["nfeat"]:
                preds = _rand_preds(rng, f"{child['name']}_f0")
            links.append(ChainLink(
                table=child["name"],
                fk_col=f"{spec['name']}_to_{child['name']}",
                pk_col=f"{child['name']}_pk",
                feature_cols=tuple(f"{child['name']}_f{k}"
                                   for k in range(child["nfeat"])),
                preds=preds,
                parent=spec["name"] if explicit else None))
            flatten(child, False)

    flatten(head, True)
    return [head], links


def _collect_specs(spec: dict) -> List[dict]:
    out = [spec]
    for c in spec["children"]:
        out.extend(_collect_specs(c))
    return out


def generate_case(seed: int, *, device: DeviceLike = None) -> FuzzCase:
    """Deterministically generate one random snowflake workload, its tables
    on ``device`` (the card unless given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_fact = int(rng.integers(16, 49))
    fact_cap = int(rng.choice(_FACT_CAPS))
    n_arms = int(rng.integers(1, 3))

    arms: List[ArmSpec] = []
    tables: Dict[str, Table] = {}
    group_candidates: List[Tuple[str, str]] = [("fact", "f_g")]
    fact_keys: Dict[str, np.ndarray] = {}

    for a in range(n_arms):
        (head,), links = _gen_dim_tree(rng, a)
        # Build child-first so parents can reference child sizes for FKs.
        for s in reversed(_collect_specs(head)):
            name, n = s["name"], s["n"]
            key_data = {f"{name}_pk": np.arange(n),
                        f"{name}_g": rng.integers(0, 3, n)}
            for child in s["children"]:
                # Child FKs miss sometimes (values past the child's PKs).
                key_data[f"{name}_to_{child['name']}"] = rng.integers(
                    0, child["n"] + 2, n)
            feats = [f"{name}_f{k}" for k in range(s["nfeat"])]
            tables[name] = _make_table(rng, name, n, s["cap"], key_data,
                                       feats, dev)
            group_candidates.append((name, f"{name}_g"))
        head_preds = ()
        if rng.random() < 0.3 and head["nfeat"]:
            head_preds = _rand_preds(rng, f"{head['name']}_f0")
        arms.append(ArmSpec(
            head["name"], f"fk{a}", f"{head['name']}_pk",
            tuple(f"{head['name']}_f{k}" for k in range(head["nfeat"])),
            head_preds, tuple(links)))
        fact_keys[f"fk{a}"] = rng.integers(0, head["n"] + 2, n_fact)

    fact_keys["f_g"] = rng.integers(0, 3, n_fact)
    measures = ["m0", "m1"]
    tables["fact"] = _make_table(rng, "fact", n_fact, fact_cap, fact_keys,
                                 measures, dev)

    # Model: none (pure relational) / linear / GEMM decision tree — over
    # however many features the arms contribute.
    width = sum(a.feature_width for a in arms)
    model = None
    roll = rng.random()
    if width and roll < 0.45:
        out = int(rng.integers(1, 3))
        model = LinearOperator(torch.from_numpy(
            rng.integers(-2, 3, (width, out)).astype(np.float32)))
    elif width and roll < 0.7:
        depth = int(rng.integers(1, 3))
        p = 2 ** depth - 1
        model = tree_from_arrays(rng.integers(0, width, p),
                                 rng.integers(-3, 4, p).astype(np.float32),
                                 width)

    fact_preds = ()
    if rng.random() < 0.4:
        fact_preds = _rand_preds(rng, str(rng.choice(measures)))

    # Prediction filters: the model_preds validity fold and (for trees
    # selecting a single leaf) the distillation rewrite.  Integer weights ×
    # integer features keep linear predictions exact, so the threshold
    # comparisons are noise-free.
    model_preds: Tuple[PredictionFilter, ...] = ()
    if model is not None and rng.random() < 0.4:
        out_dim = int(model.l)
        o = int(rng.integers(0, out_dim))
        if hasattr(model, "F"):  # tree: one-hot leaf indicator outputs
            model_preds = (PredictionFilter(o, "==", 1.0),)
        else:
            op = str(rng.choice([">", ">=", "<", "<="]))
            model_preds = (PredictionFilter(o, op,
                                            float(rng.integers(-6, 7))),)

    group_keys: Tuple[GroupKey, ...] = ()
    num_groups: int = 8
    if rng.random() < 0.6:
        picks = rng.choice(len(group_candidates),
                           size=int(rng.integers(1, 3)), replace=False)
        group_keys = tuple(GroupKey(*group_candidates[int(i)], 3, 0)
                           for i in picks)
        num_groups = 3 ** len(group_keys)

    aggs: List[Aggregate] = []
    n_aggs = int(rng.integers(1, 4))
    values: List[object] = ["m0", "m1", ("mul", "m0", "m1"),
                            ("sub", "m0", "m1"), ("add", "m0", "m1")]
    if model is not None:
        values.append(PREDICTION)
    for i in range(n_aggs):
        op = str(rng.choice(["sum", "count", "mean", "min", "max"]))
        value = (COUNT_STAR if op == "count"
                 else values[int(rng.integers(0, len(values)))])
        aggs.append(Aggregate(value, op, f"agg{i}"))

    q = PredictiveQuery("fact", tuple(arms), fact_preds, model,
                        group_keys, tuple(aggs), num_groups,
                        model_preds=model_preds)
    return FuzzCase(seed, tables, q)


# --------------------------------------------------------------------------
# Float64 numpy oracle (chain-aware)
# --------------------------------------------------------------------------
def _np_views(t: Table) -> Tuple[Dict[str, np.ndarray],
                                 Dict[str, np.ndarray]]:
    n = int(t.nvalid)
    m = _host(t.matrix)
    cols = {c: m[:n, i].astype(np.float64)
            for i, c in enumerate(t.columns)}
    keys = {c: _host(v)[:n] for c, v in t.keys.items()}
    return cols, keys


def _np_pred(p: Pred, cols, keys) -> np.ndarray:
    src = keys[p.col] if p.col in keys else cols[p.col]
    if p.op == "between":
        lo, hi = p.value
        return (src >= lo) & (src <= hi)
    if p.op == "in":
        return np.isin(src, np.asarray(list(p.value)))
    return _CMP[p.op](src, p.value)


def _np_value(cols, expr) -> np.ndarray:
    if isinstance(expr, str):
        return cols[expr]
    op, *args = expr
    if op == "col":
        return _np_value(cols, args[0])
    a, b = (_np_value(cols, x) for x in args)
    return {"add": a.__add__, "sub": a.__sub__, "mul": a.__mul__}[op](b)


def _np_model(model, x: np.ndarray) -> np.ndarray:
    if hasattr(model, "L"):
        return x @ _host(model.L).astype(np.float64)
    b = (x @ _host(model.F).astype(np.float64)
         > _host(model.v).astype(np.float64)[None, :]).astype(np.float64)
    score = b @ _host(model.H).astype(np.float64)
    return (score == _host(model.h).astype(np.float64)[None, :]
            ).astype(np.float64)


def _np_resolve(tables: Dict[str, Table], q: PredictiveQuery):
    """Per-fact-row chain resolution: validity, features, per-table ptrs.

    The oracle resolves every hop with a dict lookup per row — no factored
    joins, no composition — so agreement with the engine cross-checks the
    algebra.  Returns ``(valid, feats, ptrs, keymaps)``: ``ptrs[name]`` is
    the fact-granularity row pointer into table ``name`` (-1 on a miss;
    misses are already folded into ``valid``).
    """
    fcols, fkeys = _np_views(tables[q.fact])
    n = len(fkeys[next(iter(fkeys))]) if fkeys else int(
        tables[q.fact].nvalid)
    valid = np.ones(n, bool)
    for p in q.fact_preds:
        valid &= _np_pred(p, fcols, fkeys)
    feats: List[np.ndarray] = []
    ptrs: Dict[str, np.ndarray] = {}
    keymaps: Dict[str, Dict[str, np.ndarray]] = {}

    for arm in q.arms:
        chain = [(arm.table, None, arm.fk_col, arm.pk_col, arm.feature_cols,
                  arm.preds)]
        prev = arm.table
        for lk in arm.links:
            chain.append((lk.table,
                          lk.parent if lk.parent is not None else prev,
                          lk.fk_col, lk.pk_col, lk.feature_cols, lk.preds))
            prev = lk.table
        for name, parent, fk_col, pk_col, fcols_t, preds in chain:
            dcols, dkeys = _np_views(tables[name])
            pkmap = {int(k): i for i, k in enumerate(dkeys[pk_col])}
            if parent is None:
                fk = fkeys[fk_col]
                ptr = np.asarray([pkmap.get(int(k), -1) for k in fk])
            else:
                pfk = keymaps[parent][fk_col]
                pptr = ptrs[parent]
                ptr = np.asarray([pkmap.get(int(pfk[j]), -1)
                                  for j in np.clip(pptr, 0, None)])
                ptr = np.where(pptr < 0, -1, ptr)
            ok = ptr >= 0
            if preds:
                dmask = np.ones(len(dkeys[pk_col]), bool)
                for p in preds:
                    dmask &= _np_pred(p, dcols, dkeys)
                ok = ok & dmask[np.clip(ptr, 0, None)]
            valid &= ok
            ptrs[name] = ptr
            keymaps[name] = dkeys
            for c in fcols_t:
                feats.append(dcols[c][np.clip(ptr, 0, None)])
    return valid, feats, ptrs, keymaps


def np_oracle(tables: Dict[str, Table], q: PredictiveQuery) -> dict:
    """Brute-force float64 reference for a (possibly snowflake) query.

    Returns ``{"rows": int, "scalars": {name: (w,) float64} | None,
    "groups": {code: {name: (w,) float64}} | None}``.  ``mean`` divides
    the exact sum/count pair in float32, as the engine lowers it.
    """
    fcols, fkeys = _np_views(tables[q.fact])
    valid, feats, ptrs, keymaps = _np_resolve(tables, q)
    n = valid.shape[0]
    pred = None
    if q.model is not None:
        x = (np.stack(feats, axis=1) if feats
             else np.zeros((n, 0), np.float64))
        pred = _np_model(q.model, x)

    if q.model_preds:
        # AND semantics make miss-row feature garbage irrelevant: those
        # rows are already invalid, and on valid rows the float32 engine
        # predictions are exact, so the comparisons agree bit for bit.
        for f in q.model_preds:
            valid = valid & _CMP[f.op](pred[:, f.output], f.value)

    codes = None
    if q.group_keys:
        codes = np.zeros(n, np.int64)
        for gk in q.group_keys:
            col = (fkeys[gk.col] if gk.table == "fact" or gk.table == q.fact
                   else keymaps[gk.table][gk.col][
                       np.clip(ptrs[gk.table], 0, None)])
            codes = codes * int(gk.bound) + (col.astype(np.int64)
                                             - gk.offset)

    group_rows: Optional[Dict[int, List[int]]] = None
    if q.group_keys:
        group_rows = {}
        for i in np.nonzero(valid)[0]:
            group_rows.setdefault(int(codes[i]), []).append(int(i))

    def reduce(arr: np.ndarray, op: str) -> np.ndarray:
        if op == "count":
            return np.asarray([np.float64(arr.shape[0])])
        if op == "mean":
            # The engine lowers mean as f32 sum / f32 count; both are exact
            # here, so an f32 division reproduces it bit for bit.
            s = arr.sum(axis=0).astype(np.float32)
            return (s / np.float32(arr.shape[0])).astype(np.float64)
        if op == "min":
            return arr.min(axis=0)
        if op == "max":
            return arr.max(axis=0)
        return arr.sum(axis=0)

    groups = {} if q.group_keys else None
    scalars = None if q.group_keys else {}
    for agg in q.aggregates:
        if agg.op == "count":
            v2 = np.ones((n, 1), np.float64)
        else:
            vals = (pred if agg.value == PREDICTION
                    else _np_value(fcols, agg.value))
            v2 = vals if vals.ndim > 1 else vals[:, None]
        if q.group_keys:
            for code, idx in group_rows.items():
                groups.setdefault(code, {})[agg.name] = reduce(v2[idx],
                                                               agg.op)
        elif valid.any():
            scalars[agg.name] = reduce(v2[valid], agg.op)
        else:
            # min/max/mean over zero rows have no identity; _compare only
            # checks sum/count (== 0) for empty scalar results.
            scalars[agg.name] = None
    return {"rows": int(valid.sum()), "scalars": scalars, "groups": groups}


def np_serving_oracle(tables: Dict[str, Table], q: PredictiveQuery
                      ) -> np.ndarray:
    """Per-fact-row serving reference: model(features) × arm validity.

    Serving ignores fact-side predicates (requests are FK tuples), so only
    the join/chain/dimension-predicate validity gates each row.
    """
    q_nofact = dataclasses.replace(q, fact_preds=())
    valid, feats, _, _ = _np_resolve(tables, q_nofact)
    n = valid.shape[0]
    x = np.stack(feats, axis=1) if feats else np.zeros((n, 0), np.float64)
    out = _np_model(q.model, x)
    return out * valid[:, None]


# --------------------------------------------------------------------------
# The checker
# --------------------------------------------------------------------------
PAD_GROUP = np.int64(2**31 - 1)  # laq.aggregation's padding group code


def _engine_maps(res, names) -> Dict[str, Dict[int, np.ndarray]]:
    groups = _host(res["groups"])
    live = groups != PAD_GROUP
    out = {}
    for name in names:
        vals = _host(res[name]).astype(np.float64)
        v2 = vals if vals.ndim > 1 else vals[:, None]
        out[name] = {int(g): v2[i] for i, g in enumerate(groups)
                     if live[i]}
    return out


def _compare(res, want, q: PredictiveQuery, label: str) -> List[str]:
    """Bit-exact engine-vs-oracle comparison; returns mismatch strings."""
    bad = []
    if int(res["rows"]) != want["rows"]:
        bad.append(f"{label}: rows {int(res['rows'])} != {want['rows']}")
        return bad
    names = [a.name for a in q.aggregates]
    if want["groups"] is None:
        if want["rows"] == 0:
            # min/max/mean over zero rows are unspecified; sum/count must
            # still be exactly zero.
            for a in q.aggregates:
                if a.op in ("sum", "count"):
                    got = _host(res[a.name]).astype(np.float64)
                    if np.any(got != 0):
                        bad.append(f"{label}: {a.name} nonzero on empty")
            return bad
        for a in q.aggregates:
            got = np.atleast_1d(_host(res[a.name]).astype(np.float64)
                                ).ravel()
            exp = np.atleast_1d(want["scalars"][a.name]).ravel()
            if not np.array_equal(got, exp):
                bad.append(f"{label}: {a.name} {got} != {exp}")
        return bad
    got_maps = _engine_maps(res, names)
    for a in q.aggregates:
        exp_g = {c: v[a.name] for c, v in want["groups"].items()}
        got_g = got_maps[a.name]
        if set(got_g) != set(exp_g):
            bad.append(f"{label}: {a.name} group codes "
                       f"{sorted(got_g)} != {sorted(exp_g)}")
            continue
        for c, exp in exp_g.items():
            if not np.array_equal(got_g[c].ravel(),
                                  np.asarray(exp).ravel()):
                bad.append(f"{label}: {a.name}[{c}] "
                           f"{got_g[c].ravel()} != "
                           f"{np.asarray(exp).ravel()}")
    return bad


def _append_rows(rng: np.random.Generator, cat: Catalog,
                 tables: Dict[str, Table], name: str) -> bool:
    """Append 1-2 integer-valued rows to ``name`` (inside capacity).

    Fresh PKs continue the arange; FK/value columns draw from the same
    integer ranges as generation.  Returns False when the table is full.
    """
    t = cat[name]
    n = int(t.nvalid)
    k = min(int(rng.integers(1, 3)), t.capacity - n)
    if k <= 0:
        return False
    rows = {}
    for c in t.columns:
        if c.endswith("_pk"):
            rows[c] = np.arange(n, n + k)
        elif c in t.keys:
            # FK or group column: stay in the generated integer range
            # (child sizes are ≤ 16+2; group columns < 3) — misses are fine.
            hi = 3 if c.endswith("_g") else 18
            rows[c] = rng.integers(0, hi, k)
        else:
            rows[c] = rng.integers(-4, 5, k)
    cat.append(name, rows)
    tables[name] = cat[name]
    return True


def check_case(seed: int, *, full: bool = True,
               device: DeviceLike = None) -> List[str]:
    """Run one generated case end to end; returns mismatch descriptions.

    ``full`` runs the whole matrix — fused/nonfused × segment/matmul, the
    ``rewrite="off"`` plan, the streamed plan (``stream_chunk_rows=16``),
    the append→refresh-vs-cold-compile leg and the serving check; quick
    mode (``full=False``) runs fused and nonfused against the oracle only.
    Tables live on ``device`` (the card unless given), so every compile
    runs there.
    """
    case = generate_case(seed, device=device)
    q = case.query
    tables = dict(case.tables)
    want = np_oracle(tables, q)
    bad: List[str] = []

    combos = [(b, ab) for b in _BACKENDS for ab in
              (_AGG_BACKENDS if full else _AGG_BACKENDS[:1])]
    for backend, agg_backend in combos:
        res = compile_query(Catalog(dict(tables)), q, backend=backend,
                            agg_backend=agg_backend).run()
        bad += _compare(res, want, q,
                        f"seed={seed} {backend}/{agg_backend}")

    if full:
        # Rewrite escape hatch: the unrewritten plan must agree with the
        # (default, rewritten) plans above; both check against the same
        # oracle, so on/off bit-exactness is transitive.
        res_off = compile_query(Catalog(dict(tables)), q,
                                rewrite="off").run()
        bad += _compare(res_off, want, q, f"seed={seed} rewrite=off")

        # Out of core: stream the fact axis in small chunks and fold;
        # chunked float32 sums of integer-valued data stay exact.
        res_st = compile_query(Catalog(dict(tables)), q,
                               stream_chunk_rows=16).run()
        bad += _compare(res_st, want, q, f"seed={seed} stream[16]")

        # Append to a random participating table: the session's refresh
        # must equal a cold compile of the new catalog.
        rng = np.random.default_rng(seed + 1)
        cat = Catalog(dict(tables))
        sess = Session(cat)
        sess.compile(q).run()
        names = sorted({t for a in q.arms
                        for t in (a.table, *(lk.table for lk in a.links))}
                       | {q.fact})
        target = names[int(rng.integers(0, len(names)))]
        if _append_rows(rng, cat, tables, target):
            res = sess.compile(q).run()
            want2 = np_oracle(tables, q)
            bad += _compare(res, want2, q,
                            f"seed={seed} refresh[{target}]")
            cold = compile_query(Catalog(dict(tables)), q).run()
            bad += _compare(cold, want2, q, f"seed={seed} cold[{target}]")

    if full and q.model is not None and q.arms:
        # Serving returns raw predictions per request row — prediction
        # filters live in the aggregate path only (compile_serving rejects
        # them), so serve the unfiltered query.
        qs = dataclasses.replace(q, model_preds=())
        rt = compile_serving(Catalog(dict(tables)), qs)
        n = int(tables[q.fact].nvalid)
        reqs = requests_from_rows(tables[q.fact], qs, np.arange(n))
        got = _host(rt.serve(reqs)).astype(np.float64)
        exp = np_serving_oracle(tables, qs)
        if not np.array_equal(got, exp):
            i = int(np.argmax(np.any(got != exp, axis=1)))
            bad.append(f"seed={seed} serving: row {i} "
                       f"{got[i]} != {exp[i]}")
    return bad


def check_kernels(seed: int, *, device: DeviceLike = None) -> List[str]:
    """Mismatches of case ``seed`` on the kernels' path, which the
    reference's ``check_case`` has no counterpart of: plans under
    ``join_backend="gather"`` and ``serve_backend="kernel"``, fused and
    nonfused, against :func:`np_oracle`, and ``"kernel"`` serving runtimes
    against :func:`np_serving_oracle`, bit for bit.  On the card these
    run ``fused_star_gather`` and, for a tree, ``tree_predict``; on the
    CPU the kernels' plain versions."""
    case = generate_case(seed, device=device)
    q, tables = case.query, dict(case.tables)
    want = np_oracle(tables, q)
    bad: List[str] = []
    for backend in _BACKENDS:
        res = compile_query(Catalog(dict(tables)), q, backend=backend,
                            join_backend="gather",
                            serve_backend="kernel").run()
        bad += _compare(res, want, q, f"seed={seed} kernel {backend}")
    if q.model is not None and q.arms:
        qs = dataclasses.replace(q, model_preds=())
        exp = np_serving_oracle(tables, qs)
        fact = tables[q.fact]
        reqs = requests_from_rows(fact, qs, np.arange(int(fact.nvalid)))
        for backend in _BACKENDS:
            rt = compile_serving(Catalog(dict(tables)), qs, backend=backend,
                                 serve_backend="kernel")
            if not np.array_equal(_host(rt.serve(reqs)).astype(np.float64),
                                  exp):
                bad.append(f"seed={seed} kernel serving {backend}")
    return bad


@dataclasses.dataclass(frozen=True)
class FuzzReport:
    """Outcome of a fuzz run: seeds exercised + surviving mismatches."""

    cases: int
    seeds: Tuple[int, ...]
    failures: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        if self.ok:
            return f"fuzz: {self.cases} cases, 0 mismatches"
        return (f"fuzz: {len(self.failures)} mismatches in {self.cases} "
                f"cases; first at "
                f"{self.failures[0].split()[0]}")


def run_fuzz(cases: int, *, seed: int = 0, full_every: int = 4,
             device: DeviceLike = None) -> FuzzReport:
    """Fuzz ``cases`` randomized workloads derived from base ``seed``.

    Case seeds are ``seed*10_000 + i`` (stable, disjoint between bases).
    Every ``full_every``-th case runs the full matrix; the rest run the
    quick oracle check.  Cases run on ``device`` (the card unless given).
    """
    seeds = tuple(seed * 10_000 + i for i in range(cases))
    failures: List[str] = []
    for i, s in enumerate(seeds):
        failures.extend(check_case(s, full=(i % full_every == 0),
                                   device=device))
    return FuzzReport(cases, seeds, tuple(failures))
