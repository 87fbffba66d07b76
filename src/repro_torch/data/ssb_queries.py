"""The 13 SSB queries (Q1.1–Q4.3) + predict-then-aggregate variants P1–P4
as ``PredictiveQuery`` IR (port of the ``QUERY_IR`` registry of
``repro.data.ssb_queries``).

``QUERY_IR`` maps each name to a zero-arg builder of the IR, built with the
detached fluent builder.  Models are drawn with the same numpy calls as the
reference, so each builder gives the reference's weights; they are built on
the host and ``compile_query`` moves them to its tables' device.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.fusion import LinearOperator, random_tree
from ..core.query import PREDICTION, GroupKey, PredictiveQuery, query
from .ssb import N_BRANDS, N_NATIONS, N_REGIONS

QUERY_IR: Dict[str, Callable[[], PredictiveQuery]] = {}
_PREDICTIVE = []


def _register(name, predictive=False):
    def deco(builder):
        QUERY_IR[name] = builder
        if predictive:
            _PREDICTIVE.append(name)
        return builder
    return deco


_REVENUE = ("sum", ("mul", "lo_extendedprice", "lo_discount"))
_YEAR = GroupKey("date", "d_year", 8, offset=1992)


# --------------------------------------------------------- query group 1 ---
def _q1(date_preds, lo_preds):
    return (query("lineorder")
            .join("date", on=("lo_orderdate", "datekey"), where=date_preds)
            .where(*lo_preds)
            .agg(revenue=_REVENUE)
            .build())


@_register("Q1.1")
def q11():
    return _q1([("d_year", "==", 1993)],
               [("lo_discount", "between", (1, 3)),
                ("lo_quantity", "<", 25)])


@_register("Q1.2")
def q12():
    return _q1([("d_yearmonthnum", "==", 199401)],
               [("lo_discount", "between", (4, 6)),
                ("lo_quantity", "between", (26, 35))])


@_register("Q1.3")
def q13():
    return _q1([("d_weeknuminyear", "==", 6), ("d_year", "==", 1994)],
               [("lo_discount", "between", (5, 7)),
                ("lo_quantity", "between", (26, 35))])


# --------------------------------------------------------- query group 2 ---
def _q2(part_preds, supp_preds):
    return (query("lineorder")
            .join("part", on=("lo_partkey", "partkey"), where=part_preds)
            .join("supplier", on=("lo_suppkey", "suppkey"),
                  where=supp_preds)
            .join("date", on=("lo_orderdate", "datekey"))
            .group_by(_YEAR, ("part", "p_brand1", N_BRANDS))
            .agg(revenue="sum(lo_revenue)")
            .build())


@_register("Q2.1")
def q21():
    return _q2([("p_category", "==", 6)], [("s_region", "==", 1)])


@_register("Q2.2")
def q22():
    return _q2([("p_brand1", "between", (253, 260))],
               [("s_region", "==", 2)])


@_register("Q2.3")
def q23():
    return _q2([("p_brand1", "==", 260)], [("s_region", "==", 3)])


# --------------------------------------------------------- query group 3 ---
def _q3(cust_preds, supp_preds, date_preds, group_keys):
    return (query("lineorder")
            .join("customer", on=("lo_custkey", "custkey"),
                  where=cust_preds)
            .join("supplier", on=("lo_suppkey", "suppkey"),
                  where=supp_preds)
            .join("date", on=("lo_orderdate", "datekey"), where=date_preds)
            .group_by(*group_keys)
            .agg(revenue="sum(lo_revenue)")
            .build())


_YEARS_9297 = [("d_year", "between", (1992, 1997))]


@_register("Q3.1")
def q31():
    return _q3([("c_region", "==", 2)], [("s_region", "==", 2)],
               _YEARS_9297,
               [GroupKey("customer", "c_nation", N_NATIONS),
                GroupKey("supplier", "s_nation", N_NATIONS), _YEAR])


@_register("Q3.2")
def q32():
    return _q3([("c_nation", "==", 14)], [("s_nation", "==", 14)],
               _YEARS_9297,
               [("customer", "c_city", 250),
                ("supplier", "s_city", 250), _YEAR])


@_register("Q3.3")
def q33():
    return _q3([("c_city", "in", (141, 145))],
               [("s_city", "in", (141, 145))],
               _YEARS_9297,
               [("customer", "c_city", 250),
                ("supplier", "s_city", 250), _YEAR])


# --------------------------------------------------------- query group 4 ---
def _q4(cust_preds, supp_preds, part_preds, group_keys):
    return (query("lineorder")
            .join("customer", on=("lo_custkey", "custkey"),
                  where=cust_preds)
            .join("supplier", on=("lo_suppkey", "suppkey"),
                  where=supp_preds)
            .join("part", on=("lo_partkey", "partkey"), where=part_preds)
            .join("date", on=("lo_orderdate", "datekey"))
            .group_by(*group_keys)
            .agg(profit=("sum", ("sub", "lo_revenue", "lo_supplycost")))
            .build())


@_register("Q4.1")
def q41():
    return _q4([("c_region", "==", 1)], [("s_region", "==", 1)],
               [("p_mfgr", "in", (0, 1))],
               [_YEAR, ("customer", "c_nation", N_NATIONS)])


@_register("Q4.2")
def q42():
    return _q4([("c_region", "==", 1)], [("s_region", "==", 1)],
               [("p_mfgr", "in", (0, 1))],
               [_YEAR, ("supplier", "s_nation", N_NATIONS),
                ("part", "p_category", 25)])


@_register("Q4.3")
def q43():
    return _q4([("c_region", "==", 1)], [("s_nation", "==", 9)],
               [("p_category", "==", 8)],
               [_YEAR, ("supplier", "s_city", 250),
                ("part", "p_brand1", N_BRANDS)])


# ------------------------------------------ predict-then-aggregate (§3) ----
# SSB join shapes with a fused model head: features come from dimension
# tables, the model's linear prefix is pre-fused into them (Eq. 1/3), and the
# prediction matrix is aggregated directly (Fig. 4 / segment ops).
def _p_star(model, *, num_groups=8):
    """The shared 3-arm P* shape: part/supplier/date features + a head."""
    return (query("lineorder")
            .join("part", on=("lo_partkey", "partkey"),
                  features=("p_size", "p_category"))
            .join("supplier", on=("lo_suppkey", "suppkey"),
                  features=("s_city",))
            .join("date", on=("lo_orderdate", "datekey"),
                  features=("d_month", "d_weeknuminyear"))
            .predict(model)
            .group_by(_YEAR, num_groups=num_groups)
            .agg(prediction=("sum", PREDICTION)))


_P_K = 5   # feature width of the shared P* shape above (2 + 1 + 2)


def _linear_head(k: int, l: int, seed: int = 0) -> LinearOperator:
    rng = np.random.default_rng(seed)
    # float32 draws / float64 sqrt, rounded to float32: the reference's
    # arithmetic, so both packages hold the same weights.
    L = rng.normal(size=(k, l)).astype(np.float32) / np.sqrt(k)
    return LinearOperator(torch.from_numpy(np.asarray(L, np.float32)))


def _register_predictive(name):
    return _register(name, predictive=True)


@_register_predictive("P1.linear.year")
def p1():
    """Linear scores over part/supplier/date features, grouped by year."""
    return _p_star(_linear_head(_P_K, 4)).build()


@_register_predictive("P2.linear.select.scalar")
def p2():
    """QG1 shape: date-arm features + fact selection, scalar prediction sum."""
    return (query("lineorder")
            .join("date", on=("lo_orderdate", "datekey"),
                  features=("d_month", "d_weeknuminyear"),
                  where=[("d_year", "between", (1993, 1995))])
            .where(("lo_discount", "between", (1, 3)))
            .predict(_linear_head(2, 3, seed=1))
            .agg(prediction=("sum", PREDICTION))
            .build())


@_register_predictive("P3.tree.year")
def p3():
    """GEMM decision tree (Fig. 5) fused into the star, leaf histogram/year."""
    return _p_star(
        random_tree(np.random.default_rng(2), _P_K, depth=3)).build()


@_register_predictive("P4.tree.select.region")
def p4():
    """Tree head + selective supplier arm, leaf histogram per customer
    region."""
    return (query("lineorder")
            .join("customer", on=("lo_custkey", "custkey"),
                  features=("c_city",))
            .join("supplier", on=("lo_suppkey", "suppkey"),
                  features=("s_city",),
                  where=[("s_region", "in", (0, 1, 2))])
            .join("date", on=("lo_orderdate", "datekey"),
                  features=("d_month",))
            .predict(random_tree(np.random.default_rng(3), 3, depth=2))
            .group_by(("customer", "c_region", N_REGIONS),
                      num_groups=N_REGIONS)
            .agg(prediction=("sum", PREDICTION))
            .build())


def query_groups():
    return {
        "QG1": ["Q1.1", "Q1.2", "Q1.3"],
        "QG2": ["Q2.1", "Q2.2", "Q2.3"],
        "QG3": ["Q3.1", "Q3.2", "Q3.3"],
        "QG4": ["Q4.1", "Q4.2", "Q4.3"],
    }


def predictive_query_names():
    """The predict-then-aggregate variants, sorted."""
    return sorted(_PREDICTIVE)
