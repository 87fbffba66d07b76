"""Query/model co-optimization: exact rewrite rules over the IR (port of
``repro.core.query.rewrite``).

Every rule is **exact**: the rewritten query computes the same ``run()``
results, bit for bit, as the original on every execution path the compiler
lowers (fused/nonfused × segment/matmul, pooled).  Two rules only move
*comparisons* and are exact on any float data; two move a term between f32
summation orders and are exact on integer-valued data (the convention that
makes fused == nonfused bit-exact, see ``core.query.workload``):

``distill_tree_filter`` (any data)
    A query that filters on a *tree* model's prediction (``model_preds``)
    selects a set of leaves.  When exactly one leaf satisfies the filters,
    its root-to-leaf path conditions (``feature > v`` / ``feature <= v``)
    become ordinary dimension / link predicates and the model leaves the
    online phase.  When every leaf satisfies them, the filters are dropped.

``prune_tree_branches`` (any data)
    Range predicates already on the query fix some tree-node comparisons
    for every surviving row; those nodes leave F/v/H and their
    contribution folds into the compare vector ``h``.

``fold_constant_inputs`` (integer-valued data)
    An equality predicate pinning a dimension feature to ``u`` makes that
    model input constant: the feature leaves the arm, its row leaves ``L``,
    and ``u · L[row]`` folds into the model bias (carried by arm 0's Eq. 1
    prefused partial).

``project_zero_weights`` (integer-valued data; ±0 folded)
    Features with an all-zero ``L`` row (linear) or feeding no tree node
    (all-zero ``F`` row) contribute nothing and leave the arms and the
    model.

:func:`rewrite_query` runs the rules to a bounded fixpoint and returns the
rewritten IR plus a per-rule trail; ``compile_query(rewrite="on")`` costs
the rewritten query against the original (:func:`~.planner.
estimate_query_cost`) and surfaces the trail in ``plan.reason`` and
``explain()``.  The rules read the query's structure, the catalog's schema
and the model's small arrays, which are copied to the host once per
model; they read no table data, so a rewritten plan refreshes through the
same delta paths as an unrewritten one.  Every interval comparison is in
float32, as the tree compares.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fusion.operators import DecisionTreeGEMM, LinearOperator
from ..laq.selection import Pred
from ..laq.table import Table
from .ir import FILTER_FNS, PREDICTION, PredictiveQuery

#: Fixpoint bound: each pass only shrinks the query (fewer features, nodes,
#: filters), so a few passes converge; the bound guards against a rule
#: oscillating, it is not a tuning knob.
MAX_PASSES = 4


@dataclasses.dataclass(frozen=True)
class FeatureSite:
    """Where one model input column lives: an arm's head or one of its
    links, in the model's global feature order (arms in order; within an
    arm the head's ``feature_cols`` first, then each link's in declaration
    order — the order ``qualified_cols`` and ``_feature_slices`` use)."""

    arm: int                    # index into q.arms
    link: Optional[int]         # index into arm.links, None for the head
    table: str                  # real catalog table owning the column
    col: str


@dataclasses.dataclass(frozen=True)
class RewriteResult:
    """The rewritten IR plus the per-rule trail (empty = nothing fired)."""

    query: PredictiveQuery
    trail: Tuple[str, ...]

    @property
    def changed(self) -> bool:
        return bool(self.trail)


class _HostArrays:
    """The model heads' arrays as float32 numpy, copied off the device once
    per model; the models a rule builds register the arrays they came from,
    so they are never copied back."""

    def __init__(self):
        self._seen: Dict[int, Tuple[object, Dict[str, np.ndarray]]] = {}

    def __call__(self, model) -> Dict[str, np.ndarray]:
        hit = self._seen.get(id(model))
        if hit is not None and hit[0] is model:
            return hit[1]
        names = (("L", "bias") if isinstance(model, LinearOperator)
                 else ("F", "v", "H", "h"))
        arrays = {n: (None if getattr(model, n) is None else
                      getattr(model, n).detach().cpu().numpy())
                  for n in names}
        self._seen[id(model)] = (model, arrays)
        return arrays

    def build(self, cls, like, **arrays):
        """A new model head from numpy arrays, on ``like``'s device."""
        dev = (like.L if isinstance(like, LinearOperator) else like.F).device
        model = cls(**{n: (None if a is None else
                           torch.from_numpy(np.ascontiguousarray(a)).to(dev))
                       for n, a in arrays.items()})
        self._seen[id(model)] = (model, dict(arrays))
        return model


def feature_sites(q: PredictiveQuery) -> List[FeatureSite]:
    """Every model input column, in global (model-row) feature order."""
    sites: List[FeatureSite] = []
    for i, a in enumerate(q.arms):
        sites.extend(FeatureSite(i, None, a.table, c)
                     for c in a.feature_cols)
        for li, lk in enumerate(a.links):
            sites.extend(FeatureSite(i, li, lk.table, c)
                         for c in lk.feature_cols)
    return sites


def _site_preds(q: PredictiveQuery, s: FeatureSite) -> Tuple[Pred, ...]:
    a = q.arms[s.arm]
    return a.preds if s.link is None else a.links[s.link].preds


def _rewritable_col(catalog: Mapping[str, Table], s: FeatureSite) -> bool:
    """Only plain float matrix columns are analyzable: ``Pred.mask``
    prefers the int *key* array when the name is also a key column, whose
    integer compare does not match the f32 feature compare."""
    t = catalog.get(s.table) if hasattr(catalog, "get") else catalog[s.table]
    return t is not None and s.col not in t.keys


# -- predicate interval analysis (all comparisons in float32) ---------------
@dataclasses.dataclass
class _Bounds:
    lo: float = -np.inf
    lo_strict: bool = False
    hi: float = np.inf
    hi_strict: bool = False
    values: Optional[frozenset] = None    # finite domain, when known

    def _values_in_bounds(self):
        out = []
        for w in self.values:
            if w < self.lo or (self.lo_strict and w == self.lo):
                continue
            if w > self.hi or (self.hi_strict and w == self.hi):
                continue
            out.append(w)
        return out

    def forced(self, v: np.float32) -> Optional[bool]:
        """Is ``x > v`` decided for every x satisfying the bounds?"""
        if self.values is not None:
            vals = self._values_in_bounds()
            if not vals:
                return None        # empty domain: leave the node alone
            if all(w > v for w in vals):
                return True
            if all(w <= v for w in vals):
                return False
            return None
        if self.lo > v or (self.lo_strict and self.lo >= v):
            return True
        if self.hi <= v:
            return False
        return None

    def pinned(self) -> Optional[np.float32]:
        """The single value x must take, if the bounds pin one."""
        if self.values is not None:
            vals = self._values_in_bounds()
            return np.float32(vals[0]) if len(vals) == 1 else None
        if (self.lo == self.hi and not self.lo_strict
                and not self.hi_strict and np.isfinite(self.lo)):
            return np.float32(self.lo)
        return None


def _col_bounds(preds: Sequence[Pred], col: str) -> _Bounds:
    """Fold every predicate on ``col`` into one f32 bound set."""
    b = _Bounds()
    for p in preds:
        if p.col != col:
            continue
        if p.op == "between":
            lo, hi = (float(np.float32(p.value[0])),
                      float(np.float32(p.value[1])))
            # A non-strict bound that strictly tightens must also clear the
            # strict flag an earlier '>'/'<' left behind; at equality the
            # existing (strict) bound is already at least as tight.
            if lo > b.lo:
                b.lo, b.lo_strict = lo, False
            if hi < b.hi:
                b.hi, b.hi_strict = hi, False
        elif p.op == "==":
            vals = frozenset([float(np.float32(p.value))])
            b.values = vals if b.values is None else (b.values & vals)
        elif p.op == "in":
            vals = frozenset(float(np.float32(v)) for v in p.value)
            b.values = vals if b.values is None else (b.values & vals)
        elif p.op == ">":
            v = float(np.float32(p.value))
            if v > b.lo or (v == b.lo and not b.lo_strict):
                b.lo, b.lo_strict = v, True
        elif p.op == ">=":
            if float(np.float32(p.value)) > b.lo:
                b.lo, b.lo_strict = float(np.float32(p.value)), False
        elif p.op == "<":
            v = float(np.float32(p.value))
            if v < b.hi or (v == b.hi and not b.hi_strict):
                b.hi, b.hi_strict = v, True
        elif p.op == "<=":
            if float(np.float32(p.value)) < b.hi:
                b.hi, b.hi_strict = float(np.float32(p.value)), False
        # "!=" carries no interval information — ignored.
    return b


# -- shared feature-dropping machinery --------------------------------------
def _drop_features(q: PredictiveQuery, drop: Sequence[int]
                   ) -> Tuple[PredictiveQuery, List[str]]:
    """Remove the given global feature indices from every arm/link.

    Returns the new query (model untouched — callers shrink it) and the
    dropped ``table.col`` names for the trail.
    """
    sites = feature_sites(q)
    dropset = set(drop)
    names = [f"{sites[i].table}.{sites[i].col}" for i in sorted(dropset)]
    gi = 0
    arms = []
    for a in q.arms:
        keep_head = []
        for c in a.feature_cols:
            if gi not in dropset:
                keep_head.append(c)
            gi += 1
        links = []
        for lk in a.links:
            keep_lk = []
            for c in lk.feature_cols:
                if gi not in dropset:
                    keep_lk.append(c)
                gi += 1
            links.append(dataclasses.replace(
                lk, feature_cols=tuple(keep_lk)))
        arms.append(dataclasses.replace(
            a, feature_cols=tuple(keep_head), links=tuple(links)))
    return dataclasses.replace(q, arms=tuple(arms)), names


def _single_feature(F: np.ndarray, p: int) -> Optional[int]:
    """The feature node ``p`` tests, or None when column ``p`` of F is not
    a single 1 (a sum-of-features node, which no rule may touch)."""
    if np.count_nonzero(F[:, p]) != 1 or F[:, p].max() != 1.0:
        return None
    return int(np.argmax(F[:, p]))


# -- the rules ---------------------------------------------------------------
def _rule_distill(catalog, q: PredictiveQuery, host: _HostArrays):
    """tree→predicate distillation: compile the satisfying leaf's path
    into dimension/link predicates and drop the model entirely."""
    if not isinstance(q.model, DecisionTreeGEMM) or not q.model_preds:
        return None
    m = q.model
    l = m.l
    # A valid row's prediction is a one-hot leaf indicator, so the filters
    # select a leaf subset: evaluate them on each unit vector, with the
    # same f32 casts the folded validity applies.
    leaves = []
    for leaf in range(l):
        ok = True
        for f in q.model_preds:
            e = np.float32(1.0 if int(f.output) == leaf else 0.0)
            if not bool(FILTER_FNS[f.op](e, np.float32(f.value))):
                ok = False
                break
        if ok:
            leaves.append(leaf)
    if len(leaves) == l:
        # Vacuous filters: every leaf passes — drop the filters, keep the
        # model (nothing else changes, so this is trivially exact).
        return (dataclasses.replace(q, model_preds=()),
                "vacuous filter dropped")
    if any(a.value == PREDICTION for a in q.aggregates):
        return None             # predictions still feed an aggregate
    if len(leaves) != 1:
        return None             # OR-of-paths / empty: not expressible yet
    leaf = leaves[0]
    sites = feature_sites(q)
    arrays = host(m)
    F, H, v = arrays["F"], arrays["H"], arrays["v"]
    if F.shape[0] != len(sites):
        return None             # inconsistent IR; refuse to touch it
    # Per-site path constraints: +1 → feature > v_p, −1 → feature <= v_p.
    gt: dict = {}
    le: dict = {}
    for p in range(F.shape[1]):
        d = H[p, leaf]
        if d == 0:
            continue            # node not on this leaf's path
        si = _single_feature(F, p)
        if si is None or not _rewritable_col(catalog, sites[si]):
            return None
        vp = float(v[p])
        if d > 0:
            gt[si] = max(gt.get(si, -np.inf), vp)
        else:
            le[si] = min(le.get(si, np.inf), vp)
    for si in set(gt) & set(le):
        if le[si] <= gt[si]:
            return None         # path self-contradictory: leaf unreachable
    # Attach the distilled predicates to the owning arm/link.
    arms = list(q.arms)
    for si in sorted(set(gt) | set(le)):
        s = sites[si]
        new: List[Pred] = []
        if si in gt:
            new.append(Pred(s.col, ">", gt[si]))
        if si in le:
            new.append(Pred(s.col, "<=", le[si]))
        a = arms[s.arm]
        if s.link is None:
            arms[s.arm] = dataclasses.replace(a, preds=a.preds + tuple(new))
        else:
            links = list(a.links)
            links[s.link] = dataclasses.replace(
                links[s.link], preds=links[s.link].preds + tuple(new))
            arms[s.arm] = dataclasses.replace(a, links=tuple(links))
    q = dataclasses.replace(q, arms=tuple(arms), model=None, model_preds=())
    # The features fed only the (now dropped) model.
    q, _ = _drop_features(q, range(len(sites)))
    npreds = sum(1 for d in (gt, le) for _ in d)
    return q, f"leaf {leaf} -> {npreds} predicates, model dropped"


def _rule_fold_constants(catalog, q: PredictiveQuery, host: _HostArrays):
    """constant-input folding: equality predicates pin features, whose
    ``L`` rows fold into the model bias."""
    if not isinstance(q.model, LinearOperator):
        return None
    sites = feature_sites(q)
    arrays = host(q.model)
    L = arrays["L"]
    if L.shape[0] != len(sites):
        return None
    pinned: List[Tuple[int, np.float32]] = []
    for i, s in enumerate(sites):
        if not _rewritable_col(catalog, s):
            continue
        u = _col_bounds(_site_preds(q, s), s.col).pinned()
        if u is not None:
            pinned.append((i, u))
    if not pinned or len(pinned) >= len(sites):
        return None             # nothing pinned, or no feature would remain
    drop = [i for i, _ in pinned]
    delta = np.zeros((L.shape[1],), np.float32)
    for i, u in pinned:
        delta = delta + np.float32(u) * L[i].astype(np.float32)
    bias = delta if arrays["bias"] is None else (
        np.asarray(arrays["bias"], np.float32) + delta)
    model = host.build(LinearOperator, q.model,
                       L=np.delete(L, drop, axis=0), bias=bias)
    q, names = _drop_features(q, drop)
    return (dataclasses.replace(q, model=model),
            f"pinned {','.join(names)} into bias")


def _rule_zero_weight(catalog, q: PredictiveQuery, host: _HostArrays):
    """zero-weight feature projection: inputs with an all-zero model row
    (``L`` row / ``F`` row) leave the arms and the model."""
    if q.model is None:
        return None
    sites = feature_sites(q)
    arrays = host(q.model)
    linear = isinstance(q.model, LinearOperator)
    W = arrays["L"] if linear else arrays["F"]
    if W.shape[0] != len(sites):
        return None
    dead = [i for i in range(W.shape[0]) if not W[i].any()]
    if not dead or len(dead) >= len(sites):
        return None
    kept = np.delete(W, dead, axis=0)
    if linear:
        model = host.build(LinearOperator, q.model, L=kept,
                           bias=arrays["bias"])
    else:
        model = host.build(DecisionTreeGEMM, q.model, F=kept,
                           v=arrays["v"], H=arrays["H"], h=arrays["h"])
    q, names = _drop_features(q, dead)
    return (dataclasses.replace(q, model=model),
            f"projected {','.join(names)}")


def _rule_prune_tree(catalog, q: PredictiveQuery, host: _HostArrays):
    """predicate-implied tree pruning: nodes whose comparison the query's
    range predicates decide are folded into ``h`` and removed."""
    if not isinstance(q.model, DecisionTreeGEMM):
        return None
    sites = feature_sites(q)
    arrays = host(q.model)
    F = arrays["F"]
    if F.shape[0] != len(sites):
        return None
    v = np.asarray(arrays["v"], np.float32)
    H = np.asarray(arrays["H"], np.float32)
    h = np.asarray(arrays["h"], np.float32)
    bounds: dict = {}
    decided: dict = {}
    for p in range(F.shape[1]):
        si = _single_feature(F, p)
        if si is None:
            continue            # not a single-feature node: leave it alone
        s = sites[si]
        if not _rewritable_col(catalog, s):
            continue
        if si not in bounds:
            bounds[si] = _col_bounds(_site_preds(q, s), s.col)
        c = bounds[si].forced(np.float32(v[p]))
        if c is not None:
            decided[p] = c
    if not decided or len(decided) >= F.shape[1]:
        return None             # nothing decided, or no node would remain
    keep = [p for p in range(F.shape[1]) if p not in decided]
    # score == h  ⟺  score_kept == h − Σ_decided c_p · H[p, :]: the decided
    # terms are constant over every surviving row, so moving them into the
    # compare vector keeps the leaf one-hot exactly (±1 integer sums).
    h2 = h.copy()
    for p, c in decided.items():
        if c:
            h2 = h2 - H[p]
    model = host.build(DecisionTreeGEMM, q.model, F=F[:, keep], v=v[keep],
                       H=H[keep], h=h2)
    return (dataclasses.replace(q, model=model),
            f"{F.shape[1]}->{len(keep)} nodes")


#: Deterministic rule order.  Distillation first (it may drop the model,
#: making the model-shrinking rules no-ops); pruning last so it sees any
#: predicates the other rules introduced.
RULES: Tuple[Tuple[str, Callable], ...] = (
    ("distill_tree_filter", _rule_distill),
    ("fold_constant_inputs", _rule_fold_constants),
    ("project_zero_weights", _rule_zero_weight),
    ("prune_tree_branches", _rule_prune_tree),
)


def rewrite_query(catalog: Mapping[str, Table], q: PredictiveQuery, *,
                  max_passes: int = MAX_PASSES) -> RewriteResult:
    """Run every rewrite rule to a bounded fixpoint.

    Deterministic: rules run in :data:`RULES` order within a pass, and a
    pass that fires nothing ends the loop.  The trail records one
    ``rule(note)`` entry per firing, in order.  A rewritten model lives on
    the source model's device.
    """
    host = _HostArrays()
    trail: List[str] = []
    for _ in range(max_passes):
        fired = False
        for name, rule in RULES:
            out = rule(catalog, q, host)
            if out is None:
                continue
            q, note = out
            trail.append(f"{name}({note})")
            fired = True
        if not fired:
            break
    return RewriteResult(q, tuple(trail))
