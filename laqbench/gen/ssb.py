"""Star Schema Benchmark tables, on the device.

Every column of SSB rev. 3 (O'Neil, O'Neil, Chen): lineorder 17, part 9,
supplier 7, customer 8, date 17, in the specification's order and under
the names the configuration's ``schema`` gives.  The distributions of
``repro_torch/data/ssb.py`` (uniform foreign keys, SSB's value ranges)
are frozen here so that the program cannot move the yardstick; the
columns that generator leaves out follow TPC-H's ranges.  Strings are
dictionary codes.  Fact and dimension columns are drawn with a
``torch.Generator`` on the device, one call per column; the calendar is
the real one from 1992-01-01, a dense id per day.
"""
from __future__ import annotations

import datetime

import torch

from . import RawTable, rows

START = datetime.date(1992, 1, 1)
SEASONS = {12: 4, 1: 0, 2: 0, 3: 1, 4: 1, 5: 1, 6: 2, 7: 2, 8: 2,
           9: 3, 10: 3, 11: 3}   # Winter, Spring, Summer, Fall, Christmas
HOLIDAYS = {(1, 1), (7, 4), (11, 11), (12, 24), (12, 25), (12, 31)}
N_COLORS, N_TYPES, N_CONTAINERS = 92, 150, 40
N_PRIORITIES, N_SHIPMODES, N_SEGMENTS = 5, 7, 5


def _int(g, dev, lo, hi, n):
    return torch.randint(lo, hi, (n,), generator=g, device=dev,
                         dtype=torch.int32)


def _cents(g, dev, lo, hi, n):
    """``randint(lo, hi) / 100`` in float64, stored as float32."""
    return (_int(g, dev, lo, hi, n).double() / 100.0).float()


def _codes(g, dev, n):
    """Dictionary codes of ``n`` distinct random strings (an address, a
    phone number): a random permutation of ``0..n-1``."""
    return torch.randperm(n, generator=g, device=dev, dtype=torch.int32)


def _ids(dev, n):
    return torch.arange(n, device=dev, dtype=torch.int32)


def calendar(days: int, dev) -> dict:
    """SSB's date table over ``days`` real days from 1992-01-01."""
    cols = {k: [] for k in (
        "datekey", "d_date", "d_dayofweek", "d_month", "d_year",
        "d_yearmonthnum", "d_yearmonth", "d_daynuminweek",
        "d_daynuminmonth", "d_daynuminyear", "d_monthnuminyear",
        "d_weeknuminyear", "d_sellingseason", "d_lastdayinweekfl",
        "d_lastdayinmonthfl", "d_holidayfl", "d_weekdayfl")}
    for i in range(days):
        d = START + datetime.timedelta(days=i)
        dow = d.isoweekday() % 7                 # Sunday 0 .. Saturday 6
        yday = d.timetuple().tm_yday
        nxt = d + datetime.timedelta(days=1)
        for k, v in (
                ("datekey", i), ("d_date", i), ("d_dayofweek", dow),
                ("d_month", d.month), ("d_year", d.year),
                ("d_yearmonthnum", d.year * 100 + d.month),
                ("d_yearmonth", (d.year - START.year) * 12 + d.month - 1),
                ("d_daynuminweek", dow + 1), ("d_daynuminmonth", d.day),
                ("d_daynuminyear", yday), ("d_monthnuminyear", d.month),
                ("d_weeknuminyear", (yday - 1) // 7 + 1),
                ("d_sellingseason", SEASONS[d.month]),
                ("d_lastdayinweekfl", int(dow == 6)),
                ("d_lastdayinmonthfl", int(nxt.month != d.month)),
                ("d_holidayfl", int((d.month, d.day) in HOLIDAYS)),
                ("d_weekdayfl", int(1 <= dow <= 5))):
            cols[k].append(v)
    return {k: torch.tensor(v, dtype=torch.int32, device=dev)
            for k, v in cols.items()}


def _geo(g, dev, n):
    """(region, nation, city) codes: 5 regions, 5 nations each, 10
    cities each."""
    region = _int(g, dev, 0, 5, n)
    nation = region * 5 + _int(g, dev, 0, 5, n)
    return region, nation, nation * 10 + _int(g, dev, 0, 10, n)


def generate(config, g, dev, scale):
    n_lo = rows(config, "lineorder", scale, 32)
    n_part = rows(config, "part", scale, 16)
    n_supp = rows(config, "supplier", scale)
    n_cust = rows(config, "customer", scale)
    days = config["rows"]["date"]
    date = calendar(days, dev)

    mfgr = _int(g, dev, 0, 5, n_part)
    category = mfgr * 5 + _int(g, dev, 0, 5, n_part)
    part = {"partkey": _ids(dev, n_part),
            "p_name": _int(g, dev, 0, N_COLORS * N_COLORS, n_part),
            "p_mfgr": mfgr, "p_category": category,
            "p_brand1": category * 40 + _int(g, dev, 0, 40, n_part),
            "p_color": _int(g, dev, 0, N_COLORS, n_part),
            "p_type": _int(g, dev, 0, N_TYPES, n_part),
            "p_size": _int(g, dev, 1, 51, n_part),
            "p_container": _int(g, dev, 0, N_CONTAINERS, n_part)}

    region, nation, city = _geo(g, dev, n_supp)
    supplier = {"suppkey": _ids(dev, n_supp), "s_name": _ids(dev, n_supp),
                "s_address": _codes(g, dev, n_supp), "s_city": city,
                "s_nation": nation, "s_region": region,
                "s_phone": _codes(g, dev, n_supp)}

    region, nation, city = _geo(g, dev, n_cust)
    customer = {"custkey": _ids(dev, n_cust), "c_name": _ids(dev, n_cust),
                "c_address": _codes(g, dev, n_cust), "c_city": city,
                "c_nation": nation, "c_region": region,
                "c_phone": _codes(g, dev, n_cust),
                "c_mktsegment": _int(g, dev, 0, N_SEGMENTS, n_cust)}

    orderdate = _int(g, dev, 0, days, n_lo)
    lo = {"lo_orderkey": _ids(dev, n_lo),
          "lo_linenumber": _int(g, dev, 1, 8, n_lo),
          "lo_custkey": _int(g, dev, 0, n_cust, n_lo),
          "lo_partkey": _int(g, dev, 0, n_part, n_lo),
          "lo_suppkey": _int(g, dev, 0, n_supp, n_lo),
          "lo_orderdate": orderdate,
          "lo_orderpriority": _int(g, dev, 0, N_PRIORITIES, n_lo),
          "lo_shippriority": torch.zeros(n_lo, device=dev,
                                         dtype=torch.int32),
          "lo_quantity": _int(g, dev, 1, 51, n_lo),
          "lo_extendedprice": _cents(g, dev, 1, 600_000, n_lo),
          "lo_ordtotalprice": _cents(g, dev, 1, 7 * 600_000, n_lo),
          "lo_discount": _int(g, dev, 0, 11, n_lo),
          "lo_revenue": _cents(g, dev, 1, 600_000, n_lo),
          "lo_supplycost": _cents(g, dev, 1, 100_000, n_lo),
          "lo_tax": _int(g, dev, 0, 9, n_lo),
          "lo_commitdate": orderdate + _int(g, dev, 30, 91, n_lo),
          "lo_shipmode": _int(g, dev, 0, N_SHIPMODES, n_lo)}

    out = {"lineorder": lo, "part": part, "supplier": supplier,
           "customer": customer, "date": date}
    schema = config["schema"]
    for name, cols in out.items():
        if list(cols) != schema[name]:
            raise ValueError(f"{name}: generated {list(cols)}, the schema "
                             f"says {schema[name]}")
    # Integer-coded columns are exact int32 key columns too, as the
    # program's own SSB tables keep them; money columns are float only.
    return {name: RawTable(cols, tuple(c for c, t in cols.items()
                                       if not t.is_floating_point()))
            for name, cols in out.items()}
