"""TPC-H support for the port: the lineitem, orders, customer, supplier,
nation and region generators, Q1, Q3, Q4, Q5, Q6, Q21, Q13's shape without
its LIKE filter, and the date constants — copied from
``spark_rapids_tpu/tools/tpch.py``, so both engines run the same data (byte
for byte for one seed) and the same queries.

The generator is numpy, seeded, with dbgen-flavored value domains; prices
are double (not decimal), the common benchmarking simplification; row
counts follow the spec scale factors (6,000,000 lineitem rows per unit).
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..columnar import dtypes as dt

__all__ = ["gen_lineitem", "gen_orders", "gen_customer", "gen_supplier",
           "gen_nation", "gen_region", "q1", "q3", "q4", "q5", "q6",
           "q13_nolike", "q21"]

_EPOCH_1992 = 8035   # days from unix epoch to 1992-01-01
_DATE_RANGE = 2557   # ~7 years of ship dates

_FILLER = np.array([
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "regular", "final", "bold", "pending", "express", "silent", "even",
    "unusual", "daring", "idle", "busy", "brave", "quiet", "ruthless",
    "deposits", "requests", "packages", "accounts", "instructions", "theodolites",
    "foxes", "pinto", "beans", "dependencies", "platelets", "excuses", "ideas",
    "sheaves", "asymptotes", "dugouts", "sauternes", "warthogs", "courts"])


def _sentences(rng: np.random.Generator, n: int, words: int = 6,
               special: "tuple[str, float] | None" = None) -> np.ndarray:
    """Vectorized random comment strings from a pre-built pool of 128; with
    probability ``special[1]`` a row gets a pool entry embedding
    ``special[0]`` (a '<a>%<b>' two-word wildcard phrase)."""
    pool = np.array([" ".join(rng.choice(_FILLER, words)) for _ in range(128)])
    out = rng.choice(pool, size=n)
    if special is not None:
        phrase, prob = special
        a, b = phrase.split("%")
        hit = rng.random(n) < prob
        mid = rng.choice(_FILLER, n)
        out = np.where(hit, np.char.add(np.char.add(a + " ", mid), " " + b), out)
    return out


def gen_lineitem(sf: float, seed: int = 0, rows: int | None = None) -> pa.Table:
    n = rows if rows is not None else int(6_000_000 * sf)
    rng = np.random.default_rng(seed)
    # key domains follow the spec ratios; when ``rows`` overrides the scale
    # they derive from n ALONE so referential integrity with the sibling
    # tables' gen_all(tiny=True) row counts is preserved (orders=n/4,
    # part=n/25, supplier=n/120 — the _TINY_ROWS ratios)
    if rows is not None:
        n_ord, n_part, n_supp = max(n // 4, 1), max(n // 25, 1), max(n // 120, 1)
    else:
        n_ord, n_part, n_supp = (max(int(1_500_000 * sf), 1),
                                 max(int(200_000 * sf), 1),
                                 max(int(10_000 * sf), 1))
    orderkey = rng.integers(1, n_ord + 1, size=n) * 4
    partkey = rng.integers(1, n_part + 1, size=n)
    suppkey = rng.integers(1, n_supp + 1, size=n)
    linenumber = rng.integers(1, 8, size=n).astype(np.int32)
    quantity = rng.integers(1, 51, size=n).astype(np.float64)
    extendedprice = np.round(rng.uniform(900.0, 105_000.0, size=n), 2)
    discount = np.round(rng.integers(0, 11, size=n) * 0.01, 2)
    tax = np.round(rng.integers(0, 9, size=n) * 0.01, 2)
    shipdate = (_EPOCH_1992 + rng.integers(0, _DATE_RANGE, size=n)).astype(np.int32)
    commitdate = shipdate + rng.integers(-30, 31, size=n).astype(np.int32)
    receiptdate = shipdate + rng.integers(1, 31, size=n).astype(np.int32)
    returnflag = rng.choice(np.array(["A", "N", "R"]), size=n)
    linestatus = np.where(shipdate > _EPOCH_1992 + 1460, "O", "F")
    shipmode = rng.choice(np.array(
        ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]), size=n)
    shipinstruct = rng.choice(np.array(
        ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]), size=n)
    return pa.table({
        "l_orderkey": pa.array(orderkey, type=pa.int64()),
        "l_partkey": pa.array(partkey, type=pa.int64()),
        "l_suppkey": pa.array(suppkey, type=pa.int64()),
        "l_linenumber": pa.array(linenumber, type=pa.int32()),
        "l_quantity": pa.array(quantity),
        "l_extendedprice": pa.array(extendedprice),
        "l_discount": pa.array(discount),
        "l_tax": pa.array(tax),
        "l_returnflag": pa.array(returnflag),
        "l_linestatus": pa.array(linestatus),
        "l_shipdate": pa.array(shipdate, type=pa.int32()).cast(pa.date32()),
        "l_commitdate": pa.array(commitdate, type=pa.int32()).cast(pa.date32()),
        "l_receiptdate": pa.array(receiptdate, type=pa.int32()).cast(pa.date32()),
        "l_shipinstruct": pa.array(shipinstruct),
        "l_shipmode": pa.array(shipmode),
    })


def gen_orders(sf: float, seed: int = 1, rows: int | None = None) -> pa.Table:
    n = rows if rows is not None else int(1_500_000 * sf)
    rng = np.random.default_rng(seed)
    orderkey = np.arange(1, n + 1, dtype=np.int64) * 4
    n_cust = max(n // 5, 1) if rows is not None else max(int(150_000 * sf), 1)
    custkey = rng.integers(1, n_cust + 1, size=n)
    totalprice = np.round(rng.uniform(850.0, 560_000.0, size=n), 2)
    orderdate = (_EPOCH_1992 + rng.integers(0, _DATE_RANGE - 151, size=n)
                 ).astype(np.int32)
    orderstatus = rng.choice(np.array(["F", "O", "P"]), size=n)
    orderpriority = rng.choice(np.array(
        ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]), size=n)
    shippriority = np.zeros(n, dtype=np.int32)
    comment = _sentences(rng, n, special=("special%requests", 0.05))
    return pa.table({
        "o_orderkey": pa.array(orderkey),
        "o_custkey": pa.array(custkey, type=pa.int64()),
        "o_orderstatus": pa.array(orderstatus),
        "o_totalprice": pa.array(totalprice),
        "o_orderdate": pa.array(orderdate, type=pa.int32()).cast(pa.date32()),
        "o_orderpriority": pa.array(orderpriority),
        "o_shippriority": pa.array(shippriority),
        "o_comment": pa.array(comment),
    })


def gen_customer(sf: float, seed: int = 2, rows: int | None = None) -> pa.Table:
    n = rows if rows is not None else int(150_000 * sf)
    rng = np.random.default_rng(seed)
    custkey = np.arange(1, n + 1, dtype=np.int64)
    nationkey = rng.integers(0, 25, size=n).astype(np.int64)
    acctbal = np.round(rng.uniform(-999.99, 9999.99, size=n), 2)
    mktsegment = rng.choice(np.array(
        ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]),
        size=n)
    # phone country code = nationkey + 10 (dbgen rule) -> Q22 substring codes
    p1 = rng.integers(100, 1000, size=n).astype("U3")
    p2 = rng.integers(100, 1000, size=n).astype("U3")
    p3 = rng.integers(1000, 10000, size=n).astype("U4")
    phone = (nationkey + 10).astype("U2")
    for part in ("-", p1, "-", p2, "-", p3):
        phone = np.char.add(phone, part)
    return pa.table({
        "c_custkey": pa.array(custkey),
        "c_name": pa.array(np.char.add("Customer#", custkey.astype("U9"))),
        "c_address": pa.array(_sentences(rng, n, words=3)),
        "c_nationkey": pa.array(nationkey),
        "c_phone": pa.array(phone),
        "c_acctbal": pa.array(acctbal),
        "c_mktsegment": pa.array(mktsegment),
        "c_comment": pa.array(_sentences(rng, n)),
    })


def gen_supplier(sf: float, seed: int = 4, rows: int | None = None) -> pa.Table:
    n = rows if rows is not None else int(10_000 * sf)
    rng = np.random.default_rng(seed)
    suppkey = np.arange(1, n + 1, dtype=np.int64)
    nationkey = rng.integers(0, 25, size=n).astype(np.int64)
    phone = np.char.add((nationkey + 10).astype("U2"), "-555-0100")
    return pa.table({
        "s_suppkey": pa.array(suppkey),
        "s_name": pa.array(np.char.add("Supplier#", suppkey.astype("U9"))),
        "s_address": pa.array(_sentences(rng, n, words=3)),
        "s_nationkey": pa.array(nationkey),
        "s_phone": pa.array(phone),
        "s_acctbal": pa.array(np.round(rng.uniform(-999.99, 9999.99, size=n), 2)),
        "s_comment": pa.array(_sentences(
            rng, n, special=("Customer%Complaints", 0.05))),
    })


_NATIONS = [  # (key, name, regionkey) — dbgen nation table
    (0, "ALGERIA", 0), (1, "ARGENTINA", 1), (2, "BRAZIL", 1), (3, "CANADA", 1),
    (4, "EGYPT", 4), (5, "ETHIOPIA", 0), (6, "FRANCE", 3), (7, "GERMANY", 3),
    (8, "INDIA", 2), (9, "INDONESIA", 2), (10, "IRAN", 4), (11, "IRAQ", 4),
    (12, "JAPAN", 2), (13, "JORDAN", 4), (14, "KENYA", 0), (15, "MOROCCO", 0),
    (16, "MOZAMBIQUE", 0), (17, "PERU", 1), (18, "CHINA", 2), (19, "ROMANIA", 3),
    (20, "SAUDI ARABIA", 4), (21, "VIETNAM", 2), (22, "RUSSIA", 3),
    (23, "UNITED KINGDOM", 3), (24, "UNITED STATES", 1)]


def gen_nation() -> pa.Table:
    return pa.table({
        "n_nationkey": pa.array([k for k, _, _ in _NATIONS], type=pa.int64()),
        "n_name": pa.array([n for _, n, _ in _NATIONS]),
        "n_regionkey": pa.array([r for _, _, r in _NATIONS], type=pa.int64()),
    })


def gen_region() -> pa.Table:
    return pa.table({
        "r_regionkey": pa.array(np.arange(5, dtype=np.int64)),
        "r_name": pa.array(["AFRICA", "AMERICA", "ASIA", "EUROPE",
                            "MIDDLE EAST"]),
    })


# Queries compare dates as days-since-epoch ints via casts.
_D = {
    "1993-01-01": 8401, "1993-07-01": 8582, "1993-10-01": 8674,
    "1994-01-01": 8766, "1995-01-01": 9131, "1995-03-15": 9204,
    "1995-09-01": 9374, "1995-10-01": 9404, "1996-01-01": 9496,
    "1996-04-01": 9587, "1996-12-31": 9861, "1997-01-01": 9862,
    "1998-09-02": 10471,
}


def q1(t):
    """TPC-H Q1: pricing summary report (grouped aggregate over string
    keys, then a sort)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    sd = col("l_shipdate").cast(dt.INT)
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    return (t["lineitem"]
            .filter(sd <= lit(_D["1998-09-02"]))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg(col("l_quantity")).alias("avg_qty"),
                 F.avg(col("l_extendedprice")).alias("avg_price"),
                 F.avg(col("l_discount")).alias("avg_disc"),
                 F.count_star().alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q3(t):
    """TPC-H Q3: shipping priority (two equi-joins, a keyed aggregate, then
    the top 10 by revenue)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    od = col("o_orderdate").cast(dt.INT)
    sd = col("l_shipdate").cast(dt.INT)
    cust = t["customer"].filter(col("c_mktsegment") == lit("BUILDING"))
    orders = t["orders"].filter(od < lit(_D["1995-03-15"]))
    li = t["lineitem"].filter(sd > lit(_D["1995-03-15"]))
    joined = (cust.join(orders, condition=(col("c_custkey") == col("o_custkey")))
                  .join(li, condition=(col("o_orderkey") == col("l_orderkey"))))
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (joined.group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(rev).alias("revenue"))
            .sort(col("revenue").desc(), col("o_orderdate").asc())
            .limit(10))


def q4(t):
    """TPC-H Q4: order priority checking (EXISTS -> left-semi join)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    od = col("o_orderdate").cast(dt.INT)
    li = t["lineitem"].select(
        col("l_orderkey").alias("lk"),
        (col("l_commitdate").cast(dt.INT)
         < col("l_receiptdate").cast(dt.INT)).alias("late"))
    return (t["orders"]
            .filter((od >= lit(_D["1993-07-01"])) & (od < lit(_D["1993-10-01"])))
            .join(li.filter(col("late")), how="left_semi",
                  condition=col("o_orderkey") == col("lk"))
            .group_by("o_orderpriority")
            .agg(F.count_star().alias("order_count"))
            .sort("o_orderpriority"))


def q5(t):
    """TPC-H Q5: local supplier volume (6-way join)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    od = col("o_orderdate").cast(dt.INT)
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["customer"]
            .join(t["orders"], condition=col("c_custkey") == col("o_custkey"))
            .filter((od >= lit(_D["1994-01-01"])) & (od < lit(_D["1995-01-01"])))
            .join(t["lineitem"], condition=col("o_orderkey") == col("l_orderkey"))
            .join(t["supplier"],
                  condition=(col("l_suppkey") == col("s_suppkey"))
                  & (col("c_nationkey") == col("s_nationkey")))
            .join(t["nation"], condition=col("s_nationkey") == col("n_nationkey"))
            .join(t["region"], condition=col("n_regionkey") == col("r_regionkey"))
            .filter(col("r_name") == lit("ASIA"))
            .group_by("n_name")
            .agg(F.sum(rev).alias("revenue"))
            .sort(col("revenue").desc()))


def q6(t):
    """TPC-H Q6: forecast revenue change (scan+filter+sum, BASELINE ladder #1)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    sd = col("l_shipdate").cast(dt.INT)
    return (t["lineitem"]
            .filter((sd >= lit(_D["1994-01-01"])) & (sd < lit(_D["1995-01-01"]))
                    & (col("l_discount") >= lit(0.05))
                    & (col("l_discount") <= lit(0.07))
                    & (col("l_quantity") < lit(24.0)))
            .agg(F.sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue")))


def q13_nolike(t):
    """TPC-H Q13's shape (left outer join, then a count by customer and a
    count by that count) without its ``o_comment NOT LIKE`` filter, which
    waits for the device LIKE (ROADMAP Queue 1 step 8)."""
    from ..expr import functions as F
    col = F.col
    orders = t["orders"].select(col("o_custkey").alias("ok_custkey"),
                                col("o_orderkey"))
    return (t["customer"]
            .join(orders, how="left",
                  condition=col("c_custkey") == col("ok_custkey"))
            .group_by("c_custkey")
            .agg(F.count(col("o_orderkey")).alias("c_count"))
            .group_by("c_count")
            .agg(F.count_star().alias("custdist"))
            .sort(col("custdist").desc(), col("c_count").desc()))


def q21(t):
    """TPC-H Q21: suppliers who kept orders waiting (EXISTS + NOT EXISTS with
    non-equi residuals -> semi/anti joins)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    late = (col("l_receiptdate").cast(dt.INT)
            > col("l_commitdate").cast(dt.INT))
    l2 = t["lineitem"].select(col("l_orderkey").alias("l2_orderkey"),
                              col("l_suppkey").alias("l2_suppkey"))
    l3 = (t["lineitem"].filter(late)
          .select(col("l_orderkey").alias("l3_orderkey"),
                  col("l_suppkey").alias("l3_suppkey")))
    return (t["supplier"]
            .join(t["lineitem"].filter(late),
                  condition=col("s_suppkey") == col("l_suppkey"))
            .join(t["orders"], condition=col("o_orderkey") == col("l_orderkey"))
            .filter(col("o_orderstatus") == lit("F"))
            .join(t["nation"], condition=col("s_nationkey") == col("n_nationkey"))
            .filter(col("n_name") == lit("SAUDI ARABIA"))
            .join(l2, how="left_semi",
                  condition=(col("l_orderkey") == col("l2_orderkey"))
                  & (col("l2_suppkey") != col("l_suppkey")))
            .join(l3, how="left_anti",
                  condition=(col("l_orderkey") == col("l3_orderkey"))
                  & (col("l3_suppkey") != col("l_suppkey")))
            .group_by("s_name")
            .agg(F.count_star().alias("numwait"))
            .sort(col("numwait").desc(), col("s_name").asc())
            .limit(100))
