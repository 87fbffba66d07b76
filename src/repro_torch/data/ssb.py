"""Star Schema Benchmark (SSB) data generator (port of ``repro.data.ssb``).

The same deterministic numpy generation as the reference (O'Neil et al.,
paper Table 3), so one ``(sf, scale, seed)`` gives the same columns:
  lineorder  sf·6,000,000      (fact)
  part       200,000·(1+⌊log2 sf⌋)
  supplier   sf·2,000
  customer   sf·30,000
  date       7·365
String dimensions are dictionary-encoded to small ints; date keys are dense
ids 0..2554 with (year, month, weeknum) decode columns.  ``scale`` shrinks
every cardinality.  Tables land on ``cuda`` unless ``device`` says otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from ..core.laq import Table
from ..device import DeviceLike, resolve_device

N_REGIONS = 5
N_NATIONS = 25          # 5 per region
CITIES_PER_NATION = 10
N_MFGRS = 5
N_CATEGORIES = 25       # 5 per mfgr
N_BRANDS = 1000         # 40 per category
DATE_DAYS = 7 * 365


@dataclasses.dataclass(eq=False)
class SSBData:
    lineorder: Table
    part: Table
    supplier: Table
    customer: Table
    date: Table
    sf: float
    scale: float

    def tables(self) -> Dict[str, Table]:
        """The five tables by name — the catalog ``compile_query`` takes."""
        return {"lineorder": self.lineorder, "part": self.part,
                "supplier": self.supplier, "customer": self.customer,
                "date": self.date}


def _dim_date(rng) -> Dict[str, np.ndarray]:
    dk = np.arange(DATE_DAYS)
    year = 1992 + dk // 365
    dayinyear = dk % 365
    month = np.minimum(dayinyear // 30 + 1, 12)
    weeknum = dayinyear // 7 + 1
    yearmonthnum = (year * 100 + month)
    return {"datekey": dk, "d_year": year, "d_month": month,
            "d_weeknuminyear": weeknum, "d_yearmonthnum": yearmonthnum}


def _dim_part(rng, n) -> Dict[str, np.ndarray]:
    mfgr = rng.integers(0, N_MFGRS, n)
    category = mfgr * 5 + rng.integers(0, 5, n)
    brand = category * 40 + rng.integers(0, 40, n)
    return {"partkey": np.arange(n), "p_mfgr": mfgr, "p_category": category,
            "p_brand1": brand, "p_size": rng.integers(1, 51, n)}


def _dim_geo(rng, n, prefix, key) -> Dict[str, np.ndarray]:
    region = rng.integers(0, N_REGIONS, n)
    nation = region * 5 + rng.integers(0, 5, n)
    city = nation * CITIES_PER_NATION + rng.integers(0, CITIES_PER_NATION, n)
    return {key: np.arange(n), f"{prefix}_region": region,
            f"{prefix}_nation": nation, f"{prefix}_city": city}


def generate(sf: float = 1.0, scale: float = 1.0, seed: int = 0,
             capacity_slack: float = 1.0,
             device: DeviceLike = None) -> SSBData:
    """Generate SSB tables at scale factor ``sf``, shrunk by ``scale``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_lo = max(int(sf * 6_000_000 * scale), 32)
    n_part = max(int(200_000 * math.floor(1 + math.log2(max(sf, 1)))
                     * scale), 16)
    n_supp = max(int(sf * 2_000 * scale), 8)
    n_cust = max(int(sf * 30_000 * scale), 8)

    date_cols = _dim_date(rng)
    part_cols = _dim_part(rng, n_part)
    supp_cols = _dim_geo(rng, n_supp, "s", "suppkey")
    cust_cols = _dim_geo(rng, n_cust, "c", "custkey")

    lo = {
        "lo_orderkey": np.arange(n_lo),
        "lo_custkey": rng.integers(0, n_cust, n_lo),
        "lo_partkey": rng.integers(0, n_part, n_lo),
        "lo_suppkey": rng.integers(0, n_supp, n_lo),
        "lo_orderdate": rng.integers(0, DATE_DAYS, n_lo),
        "lo_quantity": rng.integers(1, 51, n_lo),
        "lo_extendedprice": rng.integers(1, 6_000_00, n_lo) / 100.0,
        "lo_discount": rng.integers(0, 11, n_lo),
        "lo_revenue": rng.integers(1, 6_000_00, n_lo) / 100.0,
        "lo_supplycost": rng.integers(1, 1_000_00, n_lo) / 100.0,
    }

    def table(name, cols, keys):
        cap = int(next(iter(cols.values())).shape[0] * capacity_slack)
        return Table.from_columns(name, cols, key_cols=keys, capacity=cap,
                                  device=dev)

    # Integer-coded attribute columns are exact int32 key columns too:
    # predicates and group-bys on them never round-trip through float32.
    return SSBData(
        lineorder=table("lineorder", lo,
                        ("lo_orderkey", "lo_custkey", "lo_partkey",
                         "lo_suppkey", "lo_orderdate", "lo_quantity",
                         "lo_discount")),
        part=table("part", part_cols, tuple(part_cols)),
        supplier=table("supplier", supp_cols, tuple(supp_cols)),
        customer=table("customer", cust_cols, tuple(cust_cols)),
        date=table("date", date_cols, tuple(date_cols)),
        sf=sf, scale=scale)
