"""TPC-H support for the port: the lineitem generator, Q1, Q6 and the date
constants — copied from ``spark_rapids_tpu/tools/tpch.py``, so both engines
run the same data and the same queries.

The generator is numpy, seeded, with dbgen-flavored value domains; prices
are double (not decimal), the common benchmarking simplification; row
counts follow the spec scale factors (6,000,000 lineitem rows per unit).
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..columnar import dtypes as dt

__all__ = ["gen_lineitem", "q1", "q6"]

_EPOCH_1992 = 8035   # days from unix epoch to 1992-01-01
_DATE_RANGE = 2557   # ~7 years of ship dates


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
