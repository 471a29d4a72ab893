"""TPC-H support for the port: the generators of all eight tables, the 22
queries, Q13's shape without its LIKE filter, and the date constants —
copied from ``spark_rapids_tpu/tools/tpch.py``, so both engines run the same
data (byte for byte for one seed) and the same queries.

Scalar subqueries (Q11, Q15, Q22) are ``functions.scalar_subquery``: the
session runs them before the main plan and puts their value in as a
literal. EXISTS / NOT EXISTS / IN become left-semi / left-anti joins.

The generator is numpy, seeded, with dbgen-flavored value domains; prices
are double (not decimal), the common benchmarking simplification; row
counts follow the spec scale factors (6,000,000 lineitem rows per unit).
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..columnar import dtypes as dt

__all__ = ["gen_lineitem", "gen_orders", "gen_customer", "gen_part",
           "gen_supplier", "gen_partsupp", "gen_nation", "gen_region",
           "gen_all", "build_dataframes", "QUERIES", "TABLE_GENERATORS",
           "q13_nolike"] + [f"q{i}" for i in range(1, 23)]

_EPOCH_1992 = 8035   # days from unix epoch to 1992-01-01
_DATE_RANGE = 2557   # ~7 years of ship dates

_WORDS = np.array([
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive",
    "orange", "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
    "powder", "puff", "purple", "red", "rose", "rosy", "royal", "saddle",
    "salmon", "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow",
    "spring", "steel", "tan", "thistle", "tomato", "turquoise", "violet",
    "wheat", "white", "yellow"])

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


def _built(cols: dict, columns) -> "pa.Table | None":
    """The table of ``columns`` once a generator has built all of them,
    else None. A generator checks before the draws of its string columns,
    which come after every other draw: skipping them leaves each column
    before them as the whole table holds it."""
    if columns is not None and all(c in cols for c in columns):
        return pa.table({c: cols[c] for c in columns})
    return None


def _select(table: pa.Table, columns) -> pa.Table:
    return table if columns is None else table.select(list(columns))


def gen_lineitem(sf: float, seed: int = 0, rows: int | None = None,
                 columns=None) -> pa.Table:
    """``columns``, when given, builds only those columns (each equal to
    the whole table's)."""
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
    numeric = {
        "l_orderkey": pa.array(orderkey, type=pa.int64()),
        "l_partkey": pa.array(partkey, type=pa.int64()),
        "l_suppkey": pa.array(suppkey, type=pa.int64()),
        "l_linenumber": pa.array(linenumber, type=pa.int32()),
        "l_quantity": pa.array(quantity),
        "l_extendedprice": pa.array(extendedprice),
        "l_discount": pa.array(discount),
        "l_tax": pa.array(tax),
        "l_shipdate": pa.array(shipdate, type=pa.int32()).cast(pa.date32()),
        "l_commitdate": pa.array(commitdate, type=pa.int32()).cast(pa.date32()),
        "l_receiptdate": pa.array(receiptdate, type=pa.int32()).cast(pa.date32()),
    }
    early = _built(numeric, columns)
    if early is not None:
        return early
    returnflag = rng.choice(np.array(["A", "N", "R"]), size=n)
    linestatus = np.where(shipdate > _EPOCH_1992 + 1460, "O", "F")
    shipmode = rng.choice(np.array(
        ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]), size=n)
    shipinstruct = rng.choice(np.array(
        ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]), size=n)
    n8 = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
          "l_quantity", "l_extendedprice", "l_discount", "l_tax"]
    return _select(pa.table({
        **{c: numeric[c] for c in n8},
        "l_returnflag": pa.array(returnflag),
        "l_linestatus": pa.array(linestatus),
        "l_shipdate": numeric["l_shipdate"],
        "l_commitdate": numeric["l_commitdate"],
        "l_receiptdate": numeric["l_receiptdate"],
        "l_shipinstruct": pa.array(shipinstruct),
        "l_shipmode": pa.array(shipmode),
    }), columns)


def gen_orders(sf: float, seed: int = 1, rows: int | None = None,
               columns=None) -> pa.Table:
    """``columns`` as in ``gen_lineitem``."""
    n = rows if rows is not None else int(1_500_000 * sf)
    rng = np.random.default_rng(seed)
    orderkey = np.arange(1, n + 1, dtype=np.int64) * 4
    n_cust = max(n // 5, 1) if rows is not None else max(int(150_000 * sf), 1)
    custkey = rng.integers(1, n_cust + 1, size=n)
    totalprice = np.round(rng.uniform(850.0, 560_000.0, size=n), 2)
    orderdate = (_EPOCH_1992 + rng.integers(0, _DATE_RANGE - 151, size=n)
                 ).astype(np.int32)
    numeric = {
        "o_orderkey": pa.array(orderkey),
        "o_custkey": pa.array(custkey, type=pa.int64()),
        "o_totalprice": pa.array(totalprice),
        "o_orderdate": pa.array(orderdate, type=pa.int32()).cast(pa.date32()),
        "o_shippriority": pa.array(np.zeros(n, dtype=np.int32)),
    }
    early = _built(numeric, columns)
    if early is not None:
        return early
    orderstatus = rng.choice(np.array(["F", "O", "P"]), size=n)
    orderpriority = rng.choice(np.array(
        ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]), size=n)
    comment = _sentences(rng, n, special=("special%requests", 0.05))
    return _select(pa.table({
        "o_orderkey": numeric["o_orderkey"],
        "o_custkey": numeric["o_custkey"],
        "o_orderstatus": pa.array(orderstatus),
        "o_totalprice": numeric["o_totalprice"],
        "o_orderdate": numeric["o_orderdate"],
        "o_orderpriority": pa.array(orderpriority),
        "o_shippriority": numeric["o_shippriority"],
        "o_comment": pa.array(comment),
    }), columns)


def gen_customer(sf: float, seed: int = 2, rows: int | None = None,
                 columns=None) -> pa.Table:
    """``columns`` as in ``gen_lineitem``."""
    n = rows if rows is not None else int(150_000 * sf)
    rng = np.random.default_rng(seed)
    custkey = np.arange(1, n + 1, dtype=np.int64)
    nationkey = rng.integers(0, 25, size=n).astype(np.int64)
    acctbal = np.round(rng.uniform(-999.99, 9999.99, size=n), 2)
    mktsegment = rng.choice(np.array(
        ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]),
        size=n)
    early = _built({"c_custkey": pa.array(custkey),
                    "c_nationkey": pa.array(nationkey),
                    "c_acctbal": pa.array(acctbal),
                    "c_mktsegment": pa.array(mktsegment)}, columns)
    if early is not None:
        return early
    # phone country code = nationkey + 10 (dbgen rule) -> Q22 substring codes
    p1 = rng.integers(100, 1000, size=n).astype("U3")
    p2 = rng.integers(100, 1000, size=n).astype("U3")
    p3 = rng.integers(1000, 10000, size=n).astype("U4")
    phone = (nationkey + 10).astype("U2")
    for part in ("-", p1, "-", p2, "-", p3):
        phone = np.char.add(phone, part)
    return _select(pa.table({
        "c_custkey": pa.array(custkey),
        "c_name": pa.array(np.char.add("Customer#", custkey.astype("U9"))),
        "c_address": pa.array(_sentences(rng, n, words=3)),
        "c_nationkey": pa.array(nationkey),
        "c_phone": pa.array(phone),
        "c_acctbal": pa.array(acctbal),
        "c_mktsegment": pa.array(mktsegment),
        "c_comment": pa.array(_sentences(rng, n)),
    }), columns)


_TYPE_1 = np.array(["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"])
_TYPE_2 = np.array(["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"])
_TYPE_3 = np.array(["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"])
_CONT_1 = np.array(["SM", "MED", "LG", "JUMBO", "WRAP"])
_CONT_2 = np.array(["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"])


def gen_part(sf: float, seed: int = 3, rows: int | None = None) -> pa.Table:
    n = rows if rows is not None else int(200_000 * sf)
    rng = np.random.default_rng(seed)
    name = rng.choice(_WORDS, size=(n, 5))
    p_name = name[:, 0]
    for i in range(1, 5):
        p_name = np.char.add(np.char.add(p_name, " "), name[:, i])
    p_type = np.char.add(np.char.add(
        np.char.add(rng.choice(_TYPE_1, n), " "),
        np.char.add(rng.choice(_TYPE_2, n), " ")), rng.choice(_TYPE_3, n))
    container = np.char.add(np.char.add(rng.choice(_CONT_1, n), " "),
                            rng.choice(_CONT_2, n))
    mfgr_id = rng.integers(1, 6, size=n)
    brand = np.char.add(np.char.add("Brand#", mfgr_id.astype("U1")),
                        rng.integers(1, 6, size=n).astype("U1"))
    return pa.table({
        "p_partkey": pa.array(np.arange(1, n + 1, dtype=np.int64)),
        "p_name": pa.array(p_name),
        "p_mfgr": pa.array(np.char.add("Manufacturer#", mfgr_id.astype("U1"))),
        "p_brand": pa.array(brand),
        "p_type": pa.array(p_type),
        "p_size": pa.array(rng.integers(1, 51, size=n).astype(np.int32)),
        "p_container": pa.array(container),
        "p_retailprice": pa.array(np.round(rng.uniform(900, 2000, size=n), 2)),
        "p_comment": pa.array(_sentences(rng, n, words=3)),
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


def gen_partsupp(sf: float, seed: int = 5, rows: int | None = None) -> pa.Table:
    """4 suppliers per part (dbgen layout); ps_suppkey spread deterministically
    so (ps_partkey, ps_suppkey) pairs are unique."""
    n_part = max((rows // 4) if rows is not None else int(200_000 * sf), 1)
    # supplier domain tracks gen_all's tiny ratios (supplier = partsupp/19.2)
    n_supp = max(round(rows / 19.2), 4) if rows is not None \
        else max(int(10_000 * sf), 4)
    rng = np.random.default_rng(seed)
    partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    i = np.tile(np.arange(4, dtype=np.int64), n_part)
    suppkey = ((partkey - 1 + i * max(n_supp // 4, 1)) % n_supp) + 1
    n = len(partkey)
    return pa.table({
        "ps_partkey": pa.array(partkey),
        "ps_suppkey": pa.array(suppkey),
        "ps_availqty": pa.array(rng.integers(1, 10_000, size=n).astype(np.int32)),
        "ps_supplycost": pa.array(np.round(rng.uniform(1.0, 1000.0, size=n), 2)),
        "ps_comment": pa.array(_sentences(rng, n)),
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


TABLE_GENERATORS = {
    "lineitem": gen_lineitem, "orders": gen_orders, "customer": gen_customer,
    "part": gen_part, "supplier": gen_supplier, "partsupp": gen_partsupp,
    "nation": lambda sf, **kw: gen_nation(), "region": lambda sf, **kw: gen_region(),
}

_TINY_ROWS = {"lineitem": 3000, "orders": 750, "customer": 150, "part": 120,
              "supplier": 25, "partsupp": 480}


def gen_all(sf: float, tiny: bool = False) -> "dict[str, pa.Table]":
    """All 8 tables; ``tiny=True`` caps row counts for unit tests."""
    out = {}
    for name, g in TABLE_GENERATORS.items():
        if name in ("nation", "region"):
            out[name] = g(sf)
        elif tiny:
            out[name] = g(sf, rows=_TINY_ROWS[name])
        else:
            out[name] = g(sf)
    return out


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


def q2(t):
    """TPC-H Q2: minimum-cost supplier (correlated min subquery -> groupby +
    re-join)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    base = (t["part"]
            .filter((col("p_size") == lit(15)) & col("p_type").endswith("BRASS"))
            .join(t["partsupp"], condition=col("p_partkey") == col("ps_partkey"))
            .join(t["supplier"], condition=col("ps_suppkey") == col("s_suppkey"))
            .join(t["nation"], condition=col("s_nationkey") == col("n_nationkey"))
            .join(t["region"], condition=col("n_regionkey") == col("r_regionkey"))
            .filter(col("r_name") == lit("EUROPE")))
    mincost = (base.group_by("p_partkey")
               .agg(F.min(col("ps_supplycost")).alias("min_sc"))
               .select(col("p_partkey").alias("mc_partkey"), col("min_sc")))
    return (base.join(mincost,
                      condition=(col("p_partkey") == col("mc_partkey"))
                      & (col("ps_supplycost") == col("min_sc")))
            .select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
                    "s_address", "s_phone", "s_comment")
            .sort(col("s_acctbal").desc(), col("n_name").asc(),
                  col("s_name").asc(), col("p_partkey").asc())
            .limit(100))


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


def q7(t):
    """TPC-H Q7: volume shipping (nation self-pair, year extraction)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    sd = col("l_shipdate").cast(dt.INT)
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_name").alias("supp_nation"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("cust_nation"))
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["supplier"]
            .join(t["lineitem"], condition=col("s_suppkey") == col("l_suppkey"))
            .filter((sd >= lit(_D["1995-01-01"])) & (sd <= lit(_D["1996-12-31"])))
            .join(t["orders"], condition=col("o_orderkey") == col("l_orderkey"))
            .join(t["customer"], condition=col("c_custkey") == col("o_custkey"))
            .join(n1, condition=col("s_nationkey") == col("n1_key"))
            .join(n2, condition=col("c_nationkey") == col("n2_key"))
            .filter(((col("supp_nation") == lit("FRANCE"))
                     & (col("cust_nation") == lit("GERMANY")))
                    | ((col("supp_nation") == lit("GERMANY"))
                       & (col("cust_nation") == lit("FRANCE"))))
            .with_column("l_year", F.year(col("l_shipdate")))
            .with_column("volume", rev)
            .group_by("supp_nation", "cust_nation", "l_year")
            .agg(F.sum(col("volume")).alias("revenue"))
            .sort("supp_nation", "cust_nation", "l_year"))


def q8(t):
    """TPC-H Q8: national market share (conditional aggregate ratio)."""
    from ..expr import functions as F
    col, lit, when = F.col, F.lit, F.when
    od = col("o_orderdate").cast(dt.INT)
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_regionkey").alias("n1_region"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("nation"))
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["part"]
            .filter(col("p_type") == lit("ECONOMY ANODIZED STEEL"))
            .join(t["lineitem"], condition=col("p_partkey") == col("l_partkey"))
            .join(t["supplier"], condition=col("l_suppkey") == col("s_suppkey"))
            .join(t["orders"], condition=col("l_orderkey") == col("o_orderkey"))
            .filter((od >= lit(_D["1995-01-01"])) & (od <= lit(_D["1996-12-31"])))
            .join(t["customer"], condition=col("o_custkey") == col("c_custkey"))
            .join(n1, condition=col("c_nationkey") == col("n1_key"))
            .join(t["region"], condition=col("n1_region") == col("r_regionkey"))
            .filter(col("r_name") == lit("AMERICA"))
            .join(n2, condition=col("s_nationkey") == col("n2_key"))
            .with_column("o_year", F.year(col("o_orderdate")))
            .with_column("volume", rev)
            .with_column("brazil_volume",
                         when(col("nation") == lit("BRAZIL"), col("volume"))
                         .otherwise(lit(0.0)))
            .group_by("o_year")
            .agg(F.sum(col("brazil_volume")).alias("num"),
                 F.sum(col("volume")).alias("den"))
            .with_column("mkt_share", col("num") / col("den"))
            .select("o_year", "mkt_share")
            .sort("o_year"))


def q9(t):
    """TPC-H Q9: product type profit measure."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    amount = (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
              - col("ps_supplycost") * col("l_quantity"))
    return (t["part"]
            .filter(col("p_name").contains("green"))
            .join(t["lineitem"], condition=col("p_partkey") == col("l_partkey"))
            .join(t["supplier"], condition=col("l_suppkey") == col("s_suppkey"))
            .join(t["partsupp"],
                  condition=(col("ps_suppkey") == col("l_suppkey"))
                  & (col("ps_partkey") == col("l_partkey")))
            .join(t["orders"], condition=col("l_orderkey") == col("o_orderkey"))
            .join(t["nation"], condition=col("s_nationkey") == col("n_nationkey"))
            .with_column("o_year", F.year(col("o_orderdate")))
            .with_column("amount", amount)
            .group_by("n_name", "o_year")
            .agg(F.sum(col("amount")).alias("sum_profit"))
            .sort(col("n_name").asc(), col("o_year").desc()))


def q10(t):
    """TPC-H Q10: returned item reporting (top 20 customers)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    od = col("o_orderdate").cast(dt.INT)
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["customer"]
            .join(t["orders"], condition=col("c_custkey") == col("o_custkey"))
            .filter((od >= lit(_D["1993-10-01"])) & (od < lit(_D["1994-01-01"])))
            .join(t["lineitem"], condition=col("o_orderkey") == col("l_orderkey"))
            .filter(col("l_returnflag") == lit("R"))
            .join(t["nation"], condition=col("c_nationkey") == col("n_nationkey"))
            .group_by("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                      "c_address", "c_comment")
            .agg(F.sum(rev).alias("revenue"))
            .sort(col("revenue").desc(), col("c_custkey").asc())
            .limit(20))


def q11(t):
    """TPC-H Q11: important stock identification (global-scalar HAVING via
    scalar subquery, the SQL formulation's shape)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    base = (t["partsupp"]
            .join(t["supplier"], condition=col("ps_suppkey") == col("s_suppkey"))
            .join(t["nation"], condition=col("s_nationkey") == col("n_nationkey"))
            .filter(col("n_name") == lit("GERMANY"))
            .with_column("value", col("ps_supplycost")
                         * col("ps_availqty").cast(dt.DOUBLE)))
    total = F.scalar_subquery(base.agg(F.sum(col("value")).alias("tv")))
    return (base.group_by("ps_partkey")
            .agg(F.sum(col("value")).alias("value"))
            .filter(col("value") > total * lit(0.0001))
            .select("ps_partkey", "value")
            .sort(col("value").desc(), col("ps_partkey").asc()))


def q12(t):
    """TPC-H Q12: shipping modes and order priority (conditional counts)."""
    from ..expr import functions as F
    col, lit, when = F.col, F.lit, F.when
    rd = col("l_receiptdate").cast(dt.INT)
    cd = col("l_commitdate").cast(dt.INT)
    sd = col("l_shipdate").cast(dt.INT)
    high = when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"), lit(1)) \
        .otherwise(lit(0))
    low = when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"), lit(0)) \
        .otherwise(lit(1))
    return (t["lineitem"]
            .filter(col("l_shipmode").isin("MAIL", "SHIP")
                    & (cd < rd) & (sd < cd)
                    & (rd >= lit(_D["1994-01-01"])) & (rd < lit(_D["1995-01-01"])))
            .join(t["orders"], condition=col("l_orderkey") == col("o_orderkey"))
            .with_column("high", high).with_column("low", low)
            .group_by("l_shipmode")
            .agg(F.sum(col("high")).alias("high_line_count"),
                 F.sum(col("low")).alias("low_line_count"))
            .sort("l_shipmode"))


def q13(t):
    """TPC-H Q13: customer distribution (left outer join + double grouping)."""
    from ..expr import functions as F
    col = F.col
    orders = (t["orders"]
              .filter(~col("o_comment").like("%special%requests%"))
              .select(col("o_custkey").alias("ok_custkey"), col("o_orderkey")))
    return (t["customer"]
            .join(orders, how="left",
                  condition=col("c_custkey") == col("ok_custkey"))
            .group_by("c_custkey")
            .agg(F.count(col("o_orderkey")).alias("c_count"))
            .group_by("c_count")
            .agg(F.count_star().alias("custdist"))
            .sort(col("custdist").desc(), col("c_count").desc()))


def q13_nolike(t):
    """TPC-H Q13's shape (left outer join, then a count by customer and a
    count by that count) without its ``o_comment NOT LIKE`` filter."""
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


def q14(t):
    """TPC-H Q14: promotion effect (conditional ratio over one month)."""
    from ..expr import functions as F
    col, lit, when = F.col, F.lit, F.when
    sd = col("l_shipdate").cast(dt.INT)
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["lineitem"]
            .filter((sd >= lit(_D["1995-09-01"])) & (sd < lit(_D["1995-10-01"])))
            .join(t["part"], condition=col("l_partkey") == col("p_partkey"))
            .with_column("rev", rev)
            .with_column("promo", when(col("p_type").startswith("PROMO"),
                                       col("rev")).otherwise(lit(0.0)))
            .agg(F.sum(col("promo")).alias("promo_rev"),
                 F.sum(col("rev")).alias("total_rev"))
            .with_column("promo_revenue",
                         lit(100.0) * col("promo_rev") / col("total_rev"))
            .select("promo_revenue"))


def q15(t):
    """TPC-H Q15: top supplier (max-scalar via scalar subquery)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    sd = col("l_shipdate").cast(dt.INT)
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    revenue = (t["lineitem"]
               .filter((sd >= lit(_D["1996-01-01"])) & (sd < lit(_D["1996-04-01"])))
               .with_column("rev", rev)
               .group_by("l_suppkey")
               .agg(F.sum(col("rev")).alias("total_revenue")))
    maxrev = F.scalar_subquery(
        revenue.agg(F.max(col("total_revenue")).alias("max_revenue")))
    return (t["supplier"]
            .join(revenue, condition=col("s_suppkey") == col("l_suppkey"))
            .filter(col("total_revenue") == maxrev)
            .select("s_suppkey", "s_name", "s_address", "s_phone",
                    "total_revenue")
            .sort("s_suppkey"))


def q16(t):
    """TPC-H Q16: parts/supplier relationship (NOT IN -> left-anti, count
    distinct via dedup + count)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    bad_supp = (t["supplier"]
                .filter(col("s_comment").like("%Customer%Complaints%"))
                .select(col("s_suppkey").alias("bad_key")))
    return (t["partsupp"]
            .join(t["part"], condition=col("ps_partkey") == col("p_partkey"))
            .filter((col("p_brand") != lit("Brand#45"))
                    & ~col("p_type").startswith("MEDIUM POLISHED")
                    & col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9))
            .join(bad_supp, how="left_anti",
                  condition=col("ps_suppkey") == col("bad_key"))
            .select("p_brand", "p_type", "p_size", "ps_suppkey")
            .distinct()
            .group_by("p_brand", "p_type", "p_size")
            .agg(F.count_star().alias("supplier_cnt"))
            .sort(col("supplier_cnt").desc(), col("p_brand").asc(),
                  col("p_type").asc(), col("p_size").asc()))


def q17(t):
    """TPC-H Q17: small-quantity-order revenue (correlated avg subquery)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    avgq = (t["lineitem"].group_by("l_partkey")
            .agg(F.avg(col("l_quantity")).alias("aq"))
            .select(col("l_partkey").alias("aq_partkey"),
                    (lit(0.2) * col("aq")).alias("qty_limit")))
    return (t["lineitem"]
            .join(t["part"], condition=col("l_partkey") == col("p_partkey"))
            .filter((col("p_brand") == lit("Brand#23"))
                    & (col("p_container") == lit("MED BOX")))
            .join(avgq, condition=col("l_partkey") == col("aq_partkey"))
            .filter(col("l_quantity") < col("qty_limit"))
            .agg(F.sum(col("l_extendedprice")).alias("sum_price"))
            .with_column("avg_yearly", col("sum_price") / lit(7.0))
            .select("avg_yearly"))


def q18(t):
    """TPC-H Q18: large volume customer (HAVING -> filter over grouped agg,
    IN -> left-semi)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    big = (t["lineitem"].group_by("l_orderkey")
           .agg(F.sum(col("l_quantity")).alias("sum_qty"))
           .filter(col("sum_qty") > lit(300.0))
           .select(col("l_orderkey").alias("big_key")))
    return (t["customer"]
            .join(t["orders"], condition=col("c_custkey") == col("o_custkey"))
            .join(big, how="left_semi",
                  condition=col("o_orderkey") == col("big_key"))
            .join(t["lineitem"], condition=col("o_orderkey") == col("l_orderkey"))
            .group_by("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                      "o_totalprice")
            .agg(F.sum(col("l_quantity")).alias("sum_qty"))
            .sort(col("o_totalprice").desc(), col("o_orderdate").asc(),
                  col("o_orderkey").asc())
            .limit(100))


def q19(t):
    """TPC-H Q19: discounted revenue (disjunctive join predicate)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    qty = col("l_quantity")
    sz = col("p_size")
    c1 = ((col("p_brand") == lit("Brand#12"))
          & col("p_container").isin("SM CASE", "SM BOX", "SM PACK", "SM PKG")
          & (qty >= lit(1.0)) & (qty <= lit(11.0))
          & (sz >= lit(1)) & (sz <= lit(5)))
    c2 = ((col("p_brand") == lit("Brand#23"))
          & col("p_container").isin("MED BAG", "MED BOX", "MED PKG", "MED PACK")
          & (qty >= lit(10.0)) & (qty <= lit(20.0))
          & (sz >= lit(1)) & (sz <= lit(10)))
    c3 = ((col("p_brand") == lit("Brand#34"))
          & col("p_container").isin("LG CASE", "LG BOX", "LG PACK", "LG PKG")
          & (qty >= lit(20.0)) & (qty <= lit(30.0))
          & (sz >= lit(1)) & (sz <= lit(15)))
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["lineitem"]
            .filter(col("l_shipmode").isin("AIR", "AIR REG")
                    & (col("l_shipinstruct") == lit("DELIVER IN PERSON")))
            .join(t["part"], condition=col("p_partkey") == col("l_partkey"))
            .filter(c1 | c2 | c3)
            .agg(F.sum(rev).alias("revenue")))


def q20(t):
    """TPC-H Q20: potential part promotion (nested IN -> stacked semi joins)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    sd = col("l_shipdate").cast(dt.INT)
    qty = (t["lineitem"]
           .filter((sd >= lit(_D["1994-01-01"])) & (sd < lit(_D["1995-01-01"])))
           .group_by("l_partkey", "l_suppkey")
           .agg(F.sum(col("l_quantity")).alias("sq"))
           .select(col("l_partkey").alias("lq_partkey"),
                   col("l_suppkey").alias("lq_suppkey"),
                   (lit(0.5) * col("sq")).alias("half_qty")))
    forest = (t["part"].filter(col("p_name").startswith("forest"))
              .select(col("p_partkey").alias("fp_key")))
    ps = (t["partsupp"]
          .join(forest, how="left_semi",
                condition=col("ps_partkey") == col("fp_key"))
          .join(qty, how="left_semi",
                condition=(col("ps_partkey") == col("lq_partkey"))
                & (col("ps_suppkey") == col("lq_suppkey"))
                & (col("ps_availqty").cast(dt.DOUBLE) > col("half_qty")))
          .select(col("ps_suppkey").alias("ok_supp")))
    return (t["supplier"]
            .join(ps, how="left_semi", condition=col("s_suppkey") == col("ok_supp"))
            .join(t["nation"], condition=col("s_nationkey") == col("n_nationkey"))
            .filter(col("n_name") == lit("CANADA"))
            .select("s_name", "s_address")
            .sort("s_name"))


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


def q22(t):
    """TPC-H Q22: global sales opportunity (substring country codes, global
    avg via scalar subquery, NOT EXISTS -> anti join)."""
    from ..expr import functions as F
    col, lit = F.col, F.lit
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cust = (t["customer"]
            .with_column("cntrycode", F.substring(col("c_phone"), 1, 2))
            .filter(col("cntrycode").isin(*codes)))
    avg_bal = F.scalar_subquery(
        cust.filter(col("c_acctbal") > lit(0.0))
            .agg(F.avg(col("c_acctbal")).alias("avg_bal")))
    ord_keys = t["orders"].select(col("o_custkey").alias("ord_custkey"))
    return (cust
            .filter(col("c_acctbal") > avg_bal)
            .join(ord_keys, how="left_anti",
                  condition=col("c_custkey") == col("ord_custkey"))
            .group_by("cntrycode")
            .agg(F.count_star().alias("numcust"),
                 F.sum(col("c_acctbal")).alias("totacctbal"))
            .sort("cntrycode"))


QUERIES = {f"q{i}": globals()[f"q{i}"] for i in range(1, 23)}


def build_dataframes(sess, tables: "dict[str, pa.Table]",
                     num_partitions: int = 1):
    return {name: sess.create_dataframe(tbl, num_partitions=num_partitions)
            for name, tbl in tables.items()}
