"""Lower a ``PredictiveQuery`` to an executable plan (port of
``repro.core.query.compile``, in-core and single-device).

Offline (once per compile):
  1. selection masks on the fact table and each dimension (``Pred``, §2.2),
  2. factored matching matrices per arm (``PKIndex.probe``, §3.1), with the
     dimension-side predicate masks gathered through the FK pointers — the
     selection vector folded into the join validity,
  3. the model's linear prefix pushed into the dimension tables (Eq. 1/3),
  4. composite group codes + dense group ids (§2.4.2),
  5. the whole-query cost model choosing fused/nonfused, gather/matmul,
     segment/matmul and the serving kernel.

Online (``run`` / ``predictions`` / ``predict_rows``): Σⱼ Iⱼ Pⱼ gathers
(+ ``== h`` for trees), value expressions and the group-by reduction.  The
quasi-static arrays live in one state dict; the per-arm pointers and
liveness are stacked once as ``(J, n)`` int32 / bool, the layout the
``fused_star_gather`` kernel reads, and the per-arm joins are views of them.

Not ported yet (not accepted either): Catalog refresh, artifact pools,
meshes, streaming, snowflake chains and the IR rewrite engine — the plan is
the reference's ``rewrite="off"`` plan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..fusion.operators import DecisionTreeGEMM
from ..fusion.pipeline import (PrefusedStar, predict_fused,
                               predict_fused_kernel, predict_fused_matmul,
                               predict_nonfused, predict_nonfused_kernel,
                               predict_nonfused_matmul, prefuse)
from ..laq.aggregation import (auto_num_groups, composite_code,
                               groupby_codes, matmul_aggregate,
                               segment_aggregate, segment_reduce)
from ..laq.join import FactoredJoin, pk_index, stack_joins
from ..laq.projection import mapping_matrix
from ..laq.selection import select
from ..laq.star import DimSpec, StarJoin
from ..laq.table import Table
from .explain import ExplainReport
from .ir import (AGG_OPS, FILTER_FNS, PREDICTION, PredictiveQuery,
                 eval_value)
from .planner import (SERVE_BACKENDS, QueryPlan, effective_serve_backend,
                      plan_query)


@dataclasses.dataclass
class CompiledQuery:
    """An executable plan: its online functions + quasi-static state."""

    query: PredictiveQuery
    plan: QueryPlan
    backend: str                    # "fused" | "nonfused"
    join_backend: str               # "gather" | "matmul"
    agg_backend: str                # "segment" | "matmul"
    serve_backend: str              # "torch" | "kernel"
    star: StarJoin
    prefused: Optional[PrefusedStar]
    selectivity: float              # measured fraction of surviving fact rows
    group_codes: Optional[torch.Tensor]   # sorted unique composite codes
    _rows: torch.Tensor                   # surviving-row count (int32)
    _run: Callable
    _predict: Optional[Callable]
    _predict_rows: Optional[Callable]
    _state: Dict

    def run(self) -> Dict[str, torch.Tensor]:
        """Execute the query; returns aggregates (+ "groups", "rows")."""
        out = dict(self._run(self._state))
        if self.group_codes is not None:
            out["groups"] = self.group_codes
        out["rows"] = self._rows
        return out

    def predictions(self) -> torch.Tensor:
        """The (fact_capacity, l) prediction matrix (model queries only)."""
        if self._predict is None:
            raise ValueError("query has no model")
        return self._predict(self._state)

    def predict_rows(self, row_ids) -> torch.Tensor:
        """Batched serving: predictions for a batch of fact row ids.

        Out-of-range ids follow the reference's plain (``jnp.take`` fill)
        semantics on both serve backends: NaN rows for linear heads, zero
        rows for fused tree heads (the non-fused tree sees NaN features and
        lands in its all-false leaf); negative ids wrap like numpy.
        """
        if self._predict_rows is None:
            raise ValueError("query has no model")
        ids = torch.as_tensor(row_ids, device=self._state["valid"].device)
        return self._predict_rows(ids.to(torch.int64), self._state)

    def explain(self) -> ExplainReport:
        """Structured plan report (``str()`` gives the decision line)."""
        return ExplainReport(
            kind="compiled", backend=self.backend,
            join_backend=self.join_backend, agg_backend=self.agg_backend,
            serve_backend=self.serve_backend, plan_reason=self.plan.reason,
            extras=(("selectivity", self.selectivity),))


def _assemble_star(catalog: Mapping[str, Table], q: PredictiveQuery,
                   joins: Tuple[FactoredJoin, ...]
                   ) -> Tuple[StarJoin, torch.Tensor]:
    """Fold every selection mask into the combined validity, given resolved
    per-arm joins: fact predicates AND-fold, dimension predicates gather
    through the FK pointers, prediction filters fold last."""
    fact = catalog[q.fact]
    valid = fact.valid_mask()
    for p in q.fact_preds:
        valid = valid & p.mask(fact)
    dims = []
    for arm, fj in zip(q.arms, joins):
        dim = catalog[arm.table]
        dims.append(DimSpec(dim, arm.fk_col, arm.pk_col, arm.feature_cols))
        ok = fj.found
        if arm.preds:
            dmask = arm.preds[0].mask(dim)
            for p in arm.preds[1:]:
                dmask = dmask & p.mask(dim)
            ok = ok & dmask[fj.ptr]
        valid = valid & ok
    star = StarJoin(fact=fact, dims=tuple(dims), joins=tuple(joins),
                    row_valid=valid)
    if q.model_preds:
        preds = q.model.apply(star.materialize())
        for f in q.model_preds:
            valid = valid & FILTER_FNS[f.op](
                preds[:, f.output], torch.tensor(f.value, dtype=torch.float32,
                                                 device=preds.device))
        star = dataclasses.replace(star, row_valid=valid)
    return star, valid


def _resolve_star(catalog: Mapping[str, Table], q: PredictiveQuery
                  ) -> Tuple[StarJoin, torch.Tensor]:
    """Joins + combined validity with every selection mask folded in."""
    fact = catalog[q.fact]
    joins = tuple(pk_index(catalog[arm.table].key(arm.pk_col))
                  .probe(fact.key(arm.fk_col)) for arm in q.arms)
    return _assemble_star(catalog, q, joins)


def _group_columns(catalog: Mapping[str, Table], q: PredictiveQuery,
                   star: StarJoin):
    """Exact int32 group-key columns, gathered through the arm pointers.

    Misses gather row 0, which ``composite_code``'s validity fold masks.
    """
    arm_ptr = {a.table: fj.ptr for a, fj in zip(q.arms, star.joins)}
    cols, bounds = [], []
    for gk in q.group_keys:
        if gk.table == "fact":
            c = star.fact.key(gk.col)
        else:
            c = catalog[gk.table].key(gk.col)[arm_ptr[gk.table]]
        cols.append(c - gk.offset)
        bounds.append(gk.bound)
    return cols, bounds


def _check_aggregates(q: PredictiveQuery):
    if not q.aggregates:
        raise ValueError("query has no aggregates")
    names = [a.name for a in q.aggregates]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate aggregate names {names}: each "
                         "aggregate needs a distinct result column name")
    reserved = {"rows", "groups"} & set(names)
    if reserved:
        raise ValueError(f"aggregate names {sorted(reserved)} collide with "
                         "the reserved result keys 'rows'/'groups'")
    for agg in q.aggregates:
        if agg.op not in AGG_OPS:
            raise ValueError(
                f"aggregate op {agg.op!r} (aggregate {agg.name!r}) not one "
                f"of {list(AGG_OPS)}")
        if agg.value == PREDICTION and q.model is None:
            raise ValueError("PREDICTION aggregate requires a model")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` with its default fill rules.

    Negative ids wrap once; ids still outside ``[0, n)`` read the fill
    value: NaN for floats, the type's minimum for ints, True for bools.
    """
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    out = x[idx.clamp(0, n - 1)]
    if x.dtype == torch.bool:
        fill = True
    elif x.is_floating_point():
        fill = float("nan")
    else:
        fill = torch.iinfo(x.dtype).min
    oob = oob.reshape(oob.shape + (1,) * (out.dim() - 1))
    return torch.where(oob, torch.full((), fill, dtype=x.dtype,
                                       device=x.device), out)


def _query_state(star: StarJoin, prefused: Optional[PrefusedStar],
                 gid: Optional[torch.Tensor], ptrs: torch.Tensor,
                 founds: torch.Tensor) -> Dict:
    """Every array the online functions read."""
    return {
        "fact_matrix": star.fact.matrix,
        "valid": star.row_valid,
        "ptrs": ptrs,        # (J, n) int32
        "founds": founds,    # (J, n) bool
        "dim_mats": tuple(d.dim.matrix for d in star.dims),
        "partials": (tuple(prefused.partials)
                     if prefused is not None else None),
        "h": prefused.h if prefused is not None else None,
        "gid": gid,
    }


def _star_view(star0: StarJoin, state: Dict) -> StarJoin:
    """The StarJoin skeleton rebound onto the state's arrays."""
    fact = dataclasses.replace(star0.fact, matrix=state["fact_matrix"])
    dims = tuple(
        dataclasses.replace(d, dim=dataclasses.replace(d.dim, matrix=m))
        for d, m in zip(star0.dims, state["dim_mats"]))
    joins = tuple(FactoredJoin(state["ptrs"][j], state["founds"][j])
                  for j in range(len(star0.dims)))
    return StarJoin(fact=fact, dims=dims, joins=joins,
                    row_valid=state["valid"])


def _prefused_view(state: Dict) -> Optional[PrefusedStar]:
    if state["partials"] is None:
        return None
    return PrefusedStar(tuple(state["partials"]), state["h"])


def compile_query(catalog: Mapping[str, Table], q: PredictiveQuery, *,
                  backend: str = "auto", join_backend: str = "auto",
                  agg_backend: str = "auto", serve_backend: str = "auto",
                  select_capacity: Optional[int] = None,
                  batches_per_update: float = 1000.0) -> CompiledQuery:
    """Plan + lower ``q`` against ``catalog`` (a mapping name → Table).

    The plan runs on the device of the catalog's tables; the model head is
    moved there.  ``backend`` / ``join_backend`` / ``agg_backend`` override
    the planner ("auto" defers to the cost model).  ``serve_backend`` picks
    the physical kernel for ``predict_rows`` always, and for
    ``predictions``/``run`` when the join backend is "gather": "kernel"
    runs the fused gather-sum on ``fused_star_gather`` and non-fused trees
    on ``tree_predict``; "torch" runs the plain tensor code; "auto" picks
    the kernel on ``cuda`` when the shapes fit its bounds.

    ``select_capacity`` applies the fact predicates by ``mask_select``
    compaction before the joins; row ids seen by ``predict_rows`` then
    index the compacted table.
    """
    for name, arg, allowed in (
            ("backend", backend, ("auto", "fused", "nonfused")),
            ("join_backend", join_backend, ("auto", "gather", "matmul")),
            ("agg_backend", agg_backend, ("auto", "segment", "matmul")),
            ("serve_backend", serve_backend, SERVE_BACKENDS)):
        if arg not in allowed:
            raise ValueError(f"{name} {arg!r} not one of {allowed}")
    _check_aggregates(q)
    dev = catalog[q.fact].device
    for arm in q.arms:
        if catalog[arm.table].device != dev:
            raise ValueError(
                f"table {arm.table!r} is on {catalog[arm.table].device}, the "
                f"fact table {q.fact!r} on {dev}: a plan runs on one device")
    if q.model is not None:
        q = dataclasses.replace(q, model=q.model.to(dev))
    if select_capacity is not None:
        fact = select(catalog[q.fact], q.fact_preds,
                      capacity=select_capacity)
        catalog = {**catalog, q.fact: fact}
        q = dataclasses.replace(q, fact_preds=())
    star, valid = _resolve_star(catalog, q)
    fact = star.fact
    rows = valid.sum(dtype=torch.int32)
    n_fact = int(fact.nvalid)
    sel = float(rows) / max(n_fact, 1)

    codes = None
    n_live = None
    if q.group_keys:
        cols, bounds = _group_columns(catalog, q, star)
        codes = composite_code(cols, bounds, valid)
        if q.num_groups == "auto":
            n_live = auto_num_groups(codes)
            q = dataclasses.replace(q, num_groups=n_live)
    elif q.num_groups == "auto":
        q = dataclasses.replace(
            q, num_groups=PredictiveQuery.__dataclass_fields__[
                "num_groups"].default)

    out_width = q.model.l if q.model is not None else 1
    plan = plan_query(q.model, n_fact,
                      [int(d.dim.nvalid) for d in star.dims],
                      platform=dev.type, selectivity=1.0,
                      num_groups=q.num_groups if q.group_keys else 0,
                      out_width=out_width,
                      agg_ops=tuple(a.op for a in q.aggregates),
                      batches_per_update=batches_per_update)
    backend = plan.backend if backend == "auto" else backend
    join_backend = plan.join_backend if join_backend == "auto" else join_backend
    agg_backend = ((plan.agg.backend if plan.agg else "segment")
                   if agg_backend == "auto" else agg_backend)
    serve_backend = effective_serve_backend(plan, serve_backend, backend,
                                            q.model, len(star.dims),
                                            platform=dev.type)
    if serve_backend != plan.serve_backend:
        plan = dataclasses.replace(
            plan, serve_backend=serve_backend,
            reason=f"{plan.reason}; serve={serve_backend} (caller override)")

    prefused = None
    if q.model is not None and backend == "fused":
        prefused = prefuse(star, q.model)

    uniq = gid = None
    if q.group_keys:
        uniq, gid = groupby_codes(codes, q.num_groups, n_live=n_live)

    # Stack the joins once; the star's joins become row views of the stack.
    ptrs, founds = stack_joins(star.joins)
    star = dataclasses.replace(star, joins=tuple(
        FactoredJoin(ptrs[j], founds[j]) for j in range(len(star.joins))))
    state = _query_state(star, prefused, gid, ptrs, founds)

    reduce_fn = (matmul_aggregate if agg_backend == "matmul"
                 else segment_aggregate)
    model = q.model
    num_groups = q.num_groups
    aggregates = q.aggregates
    fact_desc = q.fact

    def _predictions(state):
        star_v = _star_view(star, state)
        pre_v = _prefused_view(state)
        if backend == "fused":
            if join_backend != "gather":
                return predict_fused_matmul(star_v, pre_v)
            if serve_backend == "kernel":
                return predict_fused_kernel(star_v, pre_v,
                                            ptrs=state["ptrs"],
                                            founds=state["founds"])
            return predict_fused(star_v, pre_v)
        if join_backend != "gather":
            return predict_nonfused_matmul(star_v, model)
        if serve_backend == "kernel":   # resolved only for tree heads
            return predict_nonfused_kernel(star_v, model)
        return predict_nonfused(star_v, model)

    def _agg_values(agg, pred, fact_v, valid_v):
        """Per-row values for one aggregate (sum-masked for additive ops)."""
        if agg.value == PREDICTION:
            return pred                          # already validity-masked
        vals = eval_value(fact_v, agg.value,
                          query=f"{agg.name!r} on {fact_desc!r}")
        if agg.op in ("min", "max"):
            return vals
        return torch.where(valid_v, vals, 0.0)

    def _online(state):
        fact_v = dataclasses.replace(fact, matrix=state["fact_matrix"])
        valid_v = state["valid"]
        gid_v = state["gid"]
        pred = _predictions(state) if model is not None else None
        out = {}
        count = None
        if any(a.op in ("count", "mean") for a in aggregates):
            ones = valid_v.to(torch.float32)
            count = (reduce_fn(gid_v, ones, num_groups)
                     if gid_v is not None else ones.sum())
        for agg in aggregates:
            if agg.op == "count":
                out[agg.name] = count
                continue
            vals = _agg_values(agg, pred, fact_v, valid_v)
            if gid_v is not None:
                if agg.op in ("min", "max"):
                    out[agg.name] = segment_reduce(gid_v, vals, num_groups,
                                                   agg.op)
                elif agg.op == "mean":
                    s = reduce_fn(gid_v, vals, num_groups)
                    c = count.clamp(min=1.0)
                    out[agg.name] = s / (c[:, None] if s.dim() > 1 else c)
                else:
                    out[agg.name] = reduce_fn(gid_v, vals, num_groups)
            elif agg.op in ("min", "max"):
                fill = float("inf") if agg.op == "min" else float("-inf")
                mask = valid_v[:, None] if vals.dim() > 1 else valid_v
                masked = torch.where(mask, vals, fill)
                r = masked.amin(0) if agg.op == "min" else masked.amax(0)
                out[agg.name] = torch.where(torch.isfinite(r), r, 0.0)
            elif agg.op == "mean":
                out[agg.name] = vals.sum(0) / count.clamp(min=1.0)
            else:
                out[agg.name] = vals.sum(0)
        return out

    predict_fn = predict_rows_fn = None
    if model is not None:
        predict_fn = _predictions
        predict_rows_fn = _make_predict_rows(star, model, backend,
                                             serve_backend)

    return CompiledQuery(
        query=q, plan=plan, backend=backend, join_backend=join_backend,
        agg_backend=agg_backend, serve_backend=serve_backend, star=star,
        prefused=prefused, selectivity=sel, group_codes=uniq,
        _rows=rows, _run=_online, _predict=predict_fn,
        _predict_rows=predict_rows_fn, _state=state)


def _make_predict_rows(star: StarJoin, model, backend: str,
                       serve_backend: str):
    """Row-batched prediction: the serving path (fact rows as requests).

    ``valid``, the pointers and the liveness are gathered with the
    reference's ``jnp.take`` fill rules first, so both serve backends see
    the same inputs.  The kernel clips an out-of-range pointer where the
    plain gather reads NaN; rows whose id is out of range are therefore set
    to what the plain path gives them (NaN, or 0 after a tree's compare).
    """
    if backend == "fused" and serve_backend == "kernel":
        from ...kernels.fused_star_gather import fused_star_gather

        def fn(ids, state):
            n = state["valid"].shape[0]
            wrapped = torch.where(ids < 0, ids + n, ids)
            oob = (wrapped < 0) | (wrapped >= n)
            v = _take(state["valid"], ids)
            ptrs = _take(state["ptrs"].T, ids).T.contiguous()
            founds = _take(state["founds"].T, ids).T.contiguous()
            out = fused_star_gather(ptrs, founds, list(state["partials"]),
                                    state["h"])
            fill = float("nan") if state["h"] is None else 0.0
            out = torch.where(oob[:, None], fill, out)
            return out * v[:, None].to(out.dtype)
        return fn

    if backend == "fused":
        def fn(ids, state):
            v = _take(state["valid"], ids)
            acc = None
            for j, part in enumerate(state["partials"]):
                ptr = _take(state["ptrs"][j], ids)
                hit = _take(state["founds"][j], ids)
                p = _take(part, ptr) * hit[:, None].to(part.dtype)
                acc = p if acc is None else acc + p
            acc = acc * v[:, None].to(acc.dtype)
            if state["h"] is None:
                return acc
            eq = (acc == state["h"][None, :].to(acc.dtype))
            return eq.to(acc.dtype) * v[:, None].to(acc.dtype)
        return fn

    use_kernel = (serve_backend == "kernel"
                  and isinstance(model, DecisionTreeGEMM))

    def fn(ids, state):
        v = _take(state["valid"], ids)
        parts = []
        for j, (d, mat) in enumerate(zip(star.dims, state["dim_mats"])):
            proj = mat @ mapping_matrix(d.dim.columns, d.feature_cols,
                                        device=mat.device)
            ptr = _take(state["ptrs"][j], ids)
            hit = _take(state["founds"][j], ids)
            parts.append(_take(proj, ptr) * hit[:, None].to(proj.dtype))
        t = torch.cat(parts, dim=1) * v[:, None].to(torch.float32)
        if use_kernel:
            from ...kernels.tree_predict import tree_predict
            out = tree_predict(t.contiguous(), model.F, model.v, model.H,
                               model.h)
        else:
            out = model.apply(t)
        return out * v[:, None].to(out.dtype)
    return fn
