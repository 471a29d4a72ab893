#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--q3-sf 1] [--partitions 2]

Builds the port's CUDA kernels from ``spark_rapids_tpu_torch/csrc`` and then:

1. kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card (exact equality for ``axpy``), and the device time per call
   (CUDA graphs timed with CUDA events) of the kernel, the plain version and
   one PyTorch library call computing the same function, beside the bound
   the card's memory rate sets;
2. Q6 phase: TPC-H Q6 through ``TorchSession`` on the card, against the
   port's host engine and an independent numpy computation, with cold and
   warm wall times and a profiler trace of one more warm run;
3. UDF phase: a Q6-shaped query summing the ``pallas_axpy`` UDF, checked the
   same way, with the kernel's launch count over the run equal to the number
   of input batches (the proof that the query went through the kernel);
4. Q1 phase: TPC-H Q1 (keyed aggregate over two string keys, then a sort)
   through ``TorchSession`` on the card: its device plan node for node, the
   result against the host engine and an independent numpy computation
   (keys, row order and counts exactly, doubles at rel 1e-9), cold and warm
   walls and a profiler trace. Q1 runs no hand-written kernel: its device
   work is torch ops, and ``axpy`` must launch 0 times on it.
   Phases 2-4 run with AQE off, the plans they had before AQE was ported.
5. Q3 phase: TPC-H Q3 (two equi-joins, a keyed aggregate, top 10) over
   customer, orders and lineitem at ``--q3-sf``, with AQE on (cold, then
   warm) and off: each result against the host engine and an independent
   numpy Q3 (keys and row order exactly, revenue at rel 1e-9); the AQE plan
   node for node, with both joins demoted to broadcast by side swap, and
   the AQE-off plan's two shuffled hash joins; ``axpy`` launched 0 times;
   a profiler trace of a warm run, and the device time of each join step
   (hash build, probe walk, sorted prep, ``searchsorted`` counts, expand)
   on the run's own join inputs.

Any mismatch raises and the script exits non-zero. The line before the last
is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
_EPOCH = datetime.date(1970, 1, 1)
L2_BYTES = 50 * 2**20         # H100 L2 cache


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def _graph_ms(fn, arg_sets, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``calls`` calls captured in a CUDA
    graph (so host launch overhead is out of the measurement), replayed
    ``replays`` times between CUDA events. The calls cycle through
    ``arg_sets``, whose total size exceeds L2, so inputs come from device
    memory as they do on the query path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def kernel_phase(gen: torch.Generator) -> dict:
    from spark_rapids_tpu_torch.udf.kernels import axpy, axpy_reference

    def inputs(n):
        return tuple(torch.randn(n, generator=gen, device="cuda",
                                 dtype=torch.float32) for _ in range(3))

    max_err = 0.0
    for n in (1, 1_000_003, 1 << 20, 1 << 24):
        a, x, y = inputs(n)
        got = axpy(a, x, y)
        want = axpy_reference(a, x, y)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"axpy != axpy_reference at n={n}")
        max_err = max(max_err, float((got - want).abs().max()))
    print(f"# kernel axpy: equal to axpy_reference (exact) at "
          f"n=1,1000003,1048576,16777216", flush=True)

    timings = {}
    for n in (1 << 20, 1 << 24):
        sets = [inputs(n)
                for _ in range(max(1, math.ceil(4 * L2_BYTES / (16 * n))))]
        t = {"ms": _graph_ms(axpy, sets),
             "plain_ms": _graph_ms(axpy_reference, sets),
             "library_ms": _graph_ms(lambda a, x, y: torch.addcmul(y, a, x),
                                     sets),
             "bound_ms": 16 * n / MEM_BYTES_PER_S * 1e3}
        timings[n] = t
        print(f"# kernel axpy n={n}: kernel {t['ms']:.6f} ms, plain "
              f"{t['plain_ms']:.6f} ms, addcmul {t['library_ms']:.6f} ms, "
              f"bound {t['bound_ms']:.6f} ms (bytes)", flush=True)
    return {"max_abs_err": max_err, "timings": timings}


def _q6_predicate(col, lit, dt):
    """TPC-H Q6's filter (tools/tpch.py q6), over days-since-epoch dates."""
    sd = col("l_shipdate").cast(dt.INT)
    return ((sd >= lit(8766)) & (sd < lit(9131))
            & (col("l_discount") >= lit(0.05))
            & (col("l_discount") <= lit(0.07))
            & (col("l_quantity") < lit(24.0)))


def _q6_mask(li) -> np.ndarray:
    sd = li.column("l_shipdate").cast("int32").to_numpy()
    disc = li.column("l_discount").to_numpy()
    qty = li.column("l_quantity").to_numpy()
    return ((sd >= 8766) & (sd < 9131) & (disc >= 0.05) & (disc <= 0.07)
            & (qty < 24.0))


def _check_device_plan(q) -> None:
    """Every node above the scan is a device node or a transition."""
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.exec.transitions import DeviceToHostExec
    from spark_rapids_tpu_torch.plan.physical import CpuScanExec
    plan = q.session._physical(q.logical, True)
    stack = [plan]
    while stack:
        node = stack.pop()
        if not isinstance(node, (TpuExec, DeviceToHostExec, CpuScanExec)):
            raise AssertionError(f"{node.node_name()} is not a device node")
        stack.extend(node.children)


def query_phase(q, label: str, column: str, expect: float,
                launches: int) -> int:
    """Drive one query on the card: its plan must be all device nodes above
    the scan; a cold and a warm run, each with the kernel launch counts set
    to 0 just before and read just after (``launches`` per run expected),
    each equal to the host engine and to numpy's ``expect`` (rel 1e-9);
    then a profiler trace of one more warm run. Returns the launches read
    after the warm run."""
    from spark_rapids_tpu_torch.udf.kernels import axpy
    q.explain()
    _check_device_plan(q)
    walls = []
    results = []
    for _ in ("cold", "warm"):
        axpy.launches = 0
        t0 = time.perf_counter()
        results.append(q.collect())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launched = axpy.launches
        if launched != launches:
            raise AssertionError(f"{label}: axpy launched {launched} times, "
                                 f"expected {launches}")
    t0 = time.perf_counter()
    host = q.collect(device=False)
    t_host = time.perf_counter() - t0
    for out in results:
        _close(_value(out, column), _value(host, column),
               f"{label} device vs host engine")
        _close(_value(out, column), expect, f"{label} device vs numpy")
    print(f"# {label}: device cold {walls[0]:.3f} s, warm {walls[1]:.3f} s; "
          f"host engine {t_host:.3f} s; {column} "
          f"{_value(results[0], column)!r} (numpy {expect!r}); axpy "
          f"launches per run {launches}", flush=True)
    _profile(q, label)
    return launched


def _profile(q, label: str):
    """One more warm run under torch.profiler: the device's busy time (its
    kernels and copies) against the run's wall time, and the top device
    events. The profiler slows the host side, so the wall here is longer
    than the untraced warm wall above. Returns (busy ms, traced wall ms),
    or None when the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q.collect()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.self_device_time_total / 1e3, e.count, e.key)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"# {label} trace: the profiler recorded no device events; "
              f"device busy time not measured", flush=True)
        return None
    busy = sum(ms for ms, _, _ in dev)
    print(f"# {label} trace: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"traced wall ({100 * busy / wall_ms:.1f} %); top device events:",
          flush=True)
    for ms, count, key in sorted(dev, reverse=True)[:6]:
        print(f"#   {ms:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    return busy, wall_ms


Q1_DEVICE_PLAN = [
    "DeviceToHostExec", "TpuSortExec", "TpuLocalExchangeExec",
    "TpuProjectExec", "TpuHashAggregateExec", "TpuLocalExchangeExec",
    "TpuWholeStage[Filter+Project+HashAggregate]", "HostToDeviceExec",
    "CpuScanExec"]
Q1_SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
           "avg_qty", "avg_price", "avg_disc")


def _q1_numpy(li) -> dict:
    """TPC-H Q1 in numpy alone: the filter, then per (returnflag,
    linestatus) group, in key order, the sums, averages and row counts."""
    keep = li.column("l_shipdate").cast("int32").to_numpy() <= 10471
    cols = {c: li.column(c).to_numpy()[keep] for c in
            ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    codes, uniques = [], []
    for c in ("l_returnflag", "l_linestatus"):
        u, inv = np.unique(np.asarray(
            li.column(c).to_numpy(zero_copy_only=False)[keep], dtype=str),
            return_inverse=True)
        uniques.append(u)
        codes.append(inv.reshape(-1))
    groups, gid = np.unique(codes[0] * len(uniques[1]) + codes[1],
                            return_inverse=True)
    gid = gid.reshape(-1)
    count = np.bincount(gid)

    def gsum(x):
        return np.bincount(gid, weights=x)

    disc_price = cols["l_extendedprice"] * (1.0 - cols["l_discount"])
    return {
        "l_returnflag": [str(uniques[0][g // len(uniques[1])])
                         for g in groups],
        "l_linestatus": [str(uniques[1][g % len(uniques[1])])
                         for g in groups],
        "sum_qty": gsum(cols["l_quantity"]),
        "sum_base_price": gsum(cols["l_extendedprice"]),
        "sum_disc_price": gsum(disc_price),
        "sum_charge": gsum(disc_price * (1.0 + cols["l_tax"])),
        "avg_qty": gsum(cols["l_quantity"]) / count,
        "avg_price": gsum(cols["l_extendedprice"]) / count,
        "avg_disc": gsum(cols["l_discount"]) / count,
        "count_order": count.tolist()}


def _check_q1(out, want: dict, what: str) -> None:
    """Keys, row order and counts exactly; sums and averages at rel 1e-9."""
    for c in ("l_returnflag", "l_linestatus", "count_order"):
        got = out.column(c).to_pylist()
        if got != list(want[c]):
            raise AssertionError(f"Q1 {what}: {c} {got} != {list(want[c])}")
    for c in Q1_SUMS:
        for a, b in zip(out.column(c).to_pylist(), want[c]):
            if a is None or not math.isfinite(a):
                raise AssertionError(f"Q1 {what}: {c} = {a!r}")
            _close(a, float(b), f"Q1 {what}: {c}")


def q1_phase(q, li) -> None:
    """Drive TPC-H Q1 on the card: the device plan node for node, above the
    scan device nodes only; a cold and a warm run, each against the host
    engine and numpy, with ``axpy``'s launch count set to 0 before each and
    read after (Q1 runs no hand-written kernel, so it must stay 0); then a
    profiler trace of one more warm run."""
    from spark_rapids_tpu_torch.udf.kernels import axpy
    q.explain()
    _check_device_plan(q)
    plan = q.session._physical(q.logical, True)
    names = []
    while plan is not None:
        names.append(plan.node_name())
        plan = plan.children[0] if plan.children else None
    if names != Q1_DEVICE_PLAN:
        raise AssertionError(f"Q1 device plan {names}")
    t0 = time.perf_counter()
    want = _q1_numpy(li)
    t_numpy = time.perf_counter() - t0
    walls, results = [], []
    for _ in ("cold", "warm"):
        axpy.launches = 0
        t0 = time.perf_counter()
        results.append(q.collect())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if axpy.launches != 0:
            raise AssertionError(f"Q1: axpy launched {axpy.launches} times")
    t0 = time.perf_counter()
    host = q.collect(device=False)
    t_host = time.perf_counter() - t0
    _check_q1(host, want, "host engine vs numpy")
    for out in results:
        _check_q1(out, want, "device vs numpy")
        host_cols = {c: host.column(c).to_pylist() for c in host.column_names}
        _check_q1(out, host_cols, "device vs host engine")
    print(f"# Q1: {results[0].num_rows} groups, "
          f"{sum(want['count_order'])} rows pass the filter; device cold "
          f"{walls[0]:.3f} s, warm {walls[1]:.3f} s; host engine "
          f"{t_host:.3f} s; numpy {t_numpy:.3f} s; axpy launches per run 0",
          flush=True)
    traced = _profile(q, "Q1")
    if traced is not None:
        busy, wall_ms = traced
        print(f"# Q1 trace: device busy {100 * busy / wall_ms:.1f} %, idle "
              f"{100 - 100 * busy / wall_ms:.1f} % of the traced warm run",
              flush=True)


Q3_TREE = """\
AdaptiveExec [isFinal=True]
  DeviceToHostExec
    TpuTakeOrderedExec [n=10]
      TpuStageReaderExec [local n=1 rows=10 bytes=240]
        TpuLocalExchangeExec [local n=1]
          TpuTakeOrderedExec [n=10]
            TpuProjectExec [l_orderkey, o_orderdate, o_shippriority, revenue]
              TpuHashAggregateExec [mode=final keys=['l_orderkey', \
'o_orderdate', 'o_shippriority']]
                TpuStageReaderExec [local n=1 rows=* bytes=*]
                  TpuLocalExchangeExec [local n=1]
                    TpuWholeStage[Project+Project+HashAggregate]
                      TpuBroadcastHashJoinExec [inner lkeys=['l_orderkey'] \
rkeys=['o_orderkey']]
                        TpuStageReaderExec [local n=1 rows={li} bytes={li_b}]
                          TpuLocalExchangeExec [local n=1]
                            TpuFilterExec [(cast(col('l_shipdate') as int) \
> lit(9204))]
                              HostToDeviceExec
                                CpuScanExec [InMemory[{li_n} rows] \
cols=['l_orderkey', 'l_extendedprice', 'l_discount', 'l_shipdate']]
                        TpuStageReaderExec [local n=1 rows={co} bytes={co_b}]
                          TpuLocalExchangeExec [local n=1]
                            TpuProjectExec [c_custkey, c_mktsegment, \
o_orderkey, o_custkey, o_orderdate, o_shippriority]
                              TpuBroadcastHashJoinExec [inner \
lkeys=['o_custkey'] rkeys=['c_custkey']]
                                TpuStageReaderExec [local n=1 rows={o} \
bytes={o_b}]
                                  TpuLocalExchangeExec [local n=1]
                                    TpuFilterExec [(cast(col('o_orderdate') \
as int) < lit(9204))]
                                      HostToDeviceExec
                                        CpuScanExec [InMemory[{o_n} rows] \
cols=['o_orderkey', 'o_custkey', 'o_orderdate', 'o_shippriority']]
                                TpuStageReaderExec [local n=1 rows={c} \
bytes={c_b}]
                                  TpuLocalExchangeExec [local n=1]
                                    TpuFilterExec [(col('c_mktsegment') = \
lit('BUILDING'))]
                                      HostToDeviceExec
                                        CpuScanExec [InMemory[{c_n} rows] \
cols=['c_custkey', 'c_mktsegment']]"""
Q3_COLUMNS = ("l_orderkey", "o_orderdate", "o_shippriority", "revenue")


def _q3_numpy(customer, orders, lineitem) -> dict:
    """TPC-H Q3 in numpy alone -> the top 10 rows, and the row counts of
    each filtered table and of customer x orders (the plan's stages)."""
    seg = np.asarray(customer.column("c_mktsegment").to_numpy(
        zero_copy_only=False), dtype=str)
    custkeys = customer.column("c_custkey").to_numpy()[seg == "BUILDING"]
    odate = orders.column("o_orderdate").cast("int32").to_numpy()
    o_keep = odate < 9204
    co = o_keep & np.isin(orders.column("o_custkey").to_numpy(), custkeys)
    okey = orders.column("o_orderkey").to_numpy()[co]
    order = np.argsort(okey, kind="stable")
    l_keep = lineitem.column("l_shipdate").cast("int32").to_numpy() > 9204
    lkey = lineitem.column("l_orderkey").to_numpy()[l_keep]
    pos = np.searchsorted(okey[order], lkey).clip(0, len(okey) - 1)
    hit = okey[order][pos] == lkey
    price = lineitem.column("l_extendedprice").to_numpy()[l_keep][hit]
    disc = lineitem.column("l_discount").to_numpy()[l_keep][hit]
    revenue = np.bincount(order[pos[hit]], weights=price * (1.0 - disc),
                          minlength=len(okey))
    has = np.bincount(order[pos[hit]], minlength=len(okey)) > 0
    date = odate[co]
    idx = np.nonzero(has)[0]
    top = idx[np.lexsort((date[idx], -revenue[idx]))][:10]
    return {"l_orderkey": okey[top].tolist(),
            "o_orderdate": date[top].tolist(),
            "o_shippriority": orders.column("o_shippriority").to_numpy()[co][
                top].tolist(),
            "revenue": revenue[top].tolist(),
            "counts": {"c": int(len(custkeys)), "o": int(o_keep.sum()),
                       "co": int(co.sum()), "li": int(l_keep.sum())}}


def _check_q3(out, want: dict, what: str) -> None:
    """Keys and row order exactly, revenue at rel 1e-9."""
    days = [None if d is None else (d - _EPOCH).days
            for d in out.column("o_orderdate").to_pylist()]
    got = {"l_orderkey": out.column("l_orderkey").to_pylist(),
           "o_orderdate": days,
           "o_shippriority": out.column("o_shippriority").to_pylist()}
    for c, v in got.items():
        if v != list(want[c]):
            raise AssertionError(f"Q3 {what}: {c} {v} != {list(want[c])}")
    revenue = out.column("revenue").to_pylist()
    if len(revenue) != len(want["revenue"]):
        raise AssertionError(f"Q3 {what}: {len(revenue)} rows")
    for a, b in zip(revenue, want["revenue"]):
        if a is None or not math.isfinite(a):
            raise AssertionError(f"Q3 {what}: revenue = {a!r}")
        _close(a, float(b), f"Q3 {what}: revenue")


def _walk_plan(plan):
    """Every node of a plan, through AQE stage readers into their stages."""
    stack = [plan]
    while stack:
        node = stack.pop()
        yield node
        stage = getattr(node, "stage", None)
        stack.extend([stage.inner] if stage is not None else node.children)


def _check_q3_plan(plan, counts: dict, sizes: dict) -> None:
    """The AQE plan that ran, node for node: Q3_TREE with this run's stage
    rows and bytes (value planes only: 24 B a customer or order row, 28 a
    lineitem, 48 a customer x orders row), the partial-aggregate stage's
    counts free; above the scans device nodes only."""
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.exec.transitions import DeviceToHostExec
    from spark_rapids_tpu_torch.plan.aqe import AdaptiveExec
    from spark_rapids_tpu_torch.plan.physical import CpuScanExec
    want = Q3_TREE.format(
        li=counts["li"], li_b=28 * counts["li"], co=counts["co"],
        co_b=48 * counts["co"], o=counts["o"], o_b=24 * counts["o"],
        c=counts["c"], c_b=24 * counts["c"], **sizes).splitlines()
    got = plan.tree_string().splitlines()
    if len(got) != len(want):
        raise AssertionError("Q3 AQE plan:\n" + plan.tree_string())
    for g, w in zip(got, want):
        head, _, _ = w.partition("rows=*")
        if g != w and not (w.endswith("rows=* bytes=*]")
                           and g.startswith(head)):
            raise AssertionError(f"Q3 AQE plan line {g!r}, expected {w!r}")
    for node in _walk_plan(plan):
        if not isinstance(node, (AdaptiveExec, TpuExec, DeviceToHostExec,
                                 CpuScanExec)):
            raise AssertionError(f"Q3: {node.node_name()} is not a device "
                                 "node")


def _event_ms(fn, reps: int = 3) -> float:
    """Device time of ``fn()`` (the least of ``reps`` calls after a warm-up)
    between CUDA events. Calls that read the device on the host each round
    include the gaps those reads leave."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _build_rounds(slot_row, bv, usable) -> int:
    """Rounds the hash build's insertion took (and, the keys being unique,
    its self-probe): one more than the latest chain step at which a usable
    row found its slot."""
    from spark_rapids_tpu_torch.exec import joins as J
    T = slot_row.shape[0]
    h1, step = J.slot_hash(bv, T)
    held = torch.nonzero(slot_row >= 0).flatten()
    slot_of = torch.full_like(bv, -1)
    slot_of[slot_row[held]] = held
    pending = usable.clone()
    r = 0
    while bool(pending.any()):
        pending &= ((h1 + r * step) & (T - 1)) != slot_of
        r += 1
    return r


def _q3_join_steps(plan) -> None:
    """Time each join step on the AQE run's own join inputs: the hash build
    and the probe walks of both broadcast joins; then, with join 1's sides
    reversed (orders as a build of repeated keys, the AQE-off plan's case),
    the sorted prep, the ``searchsorted`` counts and the expand."""
    from spark_rapids_tpu_torch.columnar.device import (bucket_rows,
                                                        concat_device_tables)
    from spark_rapids_tpu_torch.exec import joins as J
    bhj = [n for n in _walk_plan(plan)
           if type(n).__name__ == "TpuBroadcastHashJoinExec"]
    for node in sorted(bhj, key=lambda n: n.left_keys):
        build = node._broadcast
        probes = node.left.stage.inner.materialize()
        bkey = build.column(node.right_keys[0])
        slot_row, bv, _ = J.build_prep_hash(bkey, build.row_mask)
        t_build = _event_ms(lambda: J.build_prep_hash(bkey, build.row_mask))
        t_probe = _event_ms(lambda: [J.pk_hash_probe(
            p.column(node.left_keys[0]), p.row_mask, slot_row, bv)
            for p in probes])
        rounds = _build_rounds(slot_row, bv,
                               bkey.validity & build.row_mask)
        print(f"# Q3 join {node.left_keys[0]}={node.right_keys[0]}: hash "
              f"build of {int(build.num_rows)} rows (capacity "
              f"{build.capacity}, {rounds} insertion rounds) {t_build:.3f} "
              f"ms; probe walk of "
              f"{sum(int(p.num_rows) for p in probes)} rows in {len(probes)} "
              f"batches {t_probe:.3f} ms", flush=True)
        if node.left_keys == ["o_custkey"]:
            orders = concat_device_tables(probes)
            customers = build
    okey = orders.column("o_custkey")
    ckey = customers.column("c_custkey")
    b_order, sv, nvalid, _ = J.build_prep_sorted(okey, orders.row_mask)
    t_prep = _event_ms(lambda: J.build_prep_sorted(okey, orders.row_mask))
    starts, counts = J.probe_count(ckey, customers.row_mask, sv, nvalid)
    t_count = _event_ms(lambda: J.probe_count(ckey, customers.row_mask, sv,
                                              nvalid))
    total = int(torch.where(customers.row_mask, counts, 0).sum())
    out_cap = bucket_rows(total)

    def expand():
        pi, bi, valid, matched, _ = J.expand_slots(
            customers.row_mask, orders.capacity, b_order, starts, counts,
            out_cap)
        return J.gather_columns(customers, pi, valid) \
            + J.gather_columns(orders, bi, matched)
    t_expand = _event_ms(expand)
    print(f"# Q3 count path (orders as the build, {int(orders.num_rows)} "
          f"rows, capacity {orders.capacity}; customers as the probe): "
          f"sorted prep {t_prep:.3f} ms; searchsorted counts {t_count:.3f} "
          f"ms; expand of {total} pairs (capacity {out_cap}) {t_expand:.3f} "
          f"ms", flush=True)


def q3_phase(tables: dict, partitions: int) -> None:
    """Drive TPC-H Q3 on the card with AQE on (cold, warm) and off, each
    result against the host engine and numpy; the AQE plan node for node
    and its events; ``axpy`` launched 0 times; a trace of a warm run and
    the join steps' device times."""
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools import tpch
    from spark_rapids_tpu_torch.udf.kernels import axpy
    t0 = time.perf_counter()
    want = _q3_numpy(tables["customer"], tables["orders"],
                     tables["lineitem"])
    t_numpy = time.perf_counter() - t0
    counts = want["counts"]
    print(f"# Q3 numpy {t_numpy:.3f} s: {counts['c']} BUILDING customers, "
          f"{counts['o']} orders and {counts['li']} lineitems pass the "
          f"filters, {counts['co']} customer x orders rows", flush=True)

    def query(conf):
        sess = TorchSession({"spark.rapids.sql.test.enabled": True, **conf})
        return sess, tpch.q3({k: sess.create_dataframe(
            v, num_partitions=partitions) for k, v in tables.items()})

    sess, q = query({})
    walls, plans = [], []
    for _ in ("cold", "warm"):
        axpy.launches = 0
        t0 = time.perf_counter()
        plan = sess._physical(q.logical, True)
        out = plan.collect().to_arrow()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if axpy.launches != 0:
            raise AssertionError(f"Q3: axpy launched {axpy.launches} times")
        _check_q3(out, want, "device (AQE on) vs numpy")
        plans.append(plan)
    plan = plans[-1]
    print(plan.tree_string(), flush=True)
    sizes = {"li_n": tables["lineitem"].num_rows,
             "o_n": tables["orders"].num_rows,
             "c_n": tables["customer"].num_rows}
    _check_q3_plan(plan, counts, sizes)
    events = plan.events
    stage = "materialized stage n=1 rows={} bytes={}"
    expect = [stage.format(counts["o"], 24 * counts["o"]),
              stage.format(counts["li"], 28 * counts["li"]),
              stage.format(counts["c"], 24 * counts["c"]),
              "demoted inner join to broadcast via side swap (build side "
              f"{24 * counts['c']}B)",
              stage.format(counts["co"], 48 * counts["co"]),
              "demoted inner join to broadcast via side swap (build side "
              f"{48 * counts['co']}B)"]
    if events[:6] != expect or len(events) != 8 \
            or events[7] != stage.format(10, 240) \
            or not events[6].startswith("materialized stage n=1 rows="):
        raise AssertionError(f"Q3 AQE events {events}")
    print("# Q3 AQE events: " + "; ".join(events), flush=True)

    off_sess, off_q = query({"spark.rapids.tpu.aqe.enabled": False})
    axpy.launches = 0
    t0 = time.perf_counter()
    off_plan = off_sess._physical(off_q.logical, True)
    off = off_plan.collect().to_arrow()
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    if axpy.launches != 0:
        raise AssertionError(f"Q3 AQE off: axpy launched {axpy.launches}")
    if off_plan.tree_string().count("TpuShuffledHashJoinExec") != 2:
        raise AssertionError("Q3 AQE-off plan:\n" + off_plan.tree_string())
    _check_q3(off, want, "device (AQE off) vs numpy")
    t0 = time.perf_counter()
    host = q.collect(device=False)
    t_host = time.perf_counter() - t0
    _check_q3(host, want, "host engine vs numpy")
    host_cols = {c: host.column(c).to_pylist() for c in Q3_COLUMNS}
    host_cols["o_orderdate"] = [(d - _EPOCH).days
                                for d in host_cols["o_orderdate"]]
    _check_q3(off, host_cols, "device (AQE off) vs host engine")
    _check_q3(out, host_cols, "device (AQE on) vs host engine")
    print(f"# Q3: device AQE on cold {walls[0]:.3f} s, warm {walls[1]:.3f} "
          f"s; AQE off {t_off:.3f} s; host engine {t_host:.3f} s; numpy "
          f"{t_numpy:.3f} s; axpy launches per run 0", flush=True)
    traced = _profile(q, "Q3")
    if traced is not None:
        busy, wall_ms = traced
        print(f"# Q3 trace: device busy {100 * busy / wall_ms:.1f} %, idle "
              f"{100 - 100 * busy / wall_ms:.1f} % of the traced warm run",
              flush=True)
    _q3_join_steps(plan)


def _value(table, name: str) -> float:
    if table.num_rows != 1:
        raise AssertionError(f"expected one result row, got {table.num_rows}")
    v = table.column(name)[0].as_py()
    if v is None or not math.isfinite(v):
        raise AssertionError(f"{name} = {v!r}")
    return v


def _close(a: float, b: float, what: str) -> None:
    if not math.isclose(a, b, rel_tol=1e-9):
        raise AssertionError(f"{what}: {a!r} vs {b!r} (rel 1e-9)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of lineitem (default 1)")
    ap.add_argument("--q3-sf", type=float, default=1.0,
                    help="TPC-H scale factor of Q3's tables (default 1)")
    ap.add_argument("--partitions", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.expr.functions import col, lit
    from spark_rapids_tpu_torch.expr.functions import sum as fsum
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools import tpch
    from spark_rapids_tpu_torch.udf.examples import pallas_axpy

    card = _card_line()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    native.load_kernels()
    print(f"# kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {native.build_seconds:.2f} s)", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kern = kernel_phase(gen)

    t0 = time.perf_counter()
    li = tpch.gen_lineitem(args.sf, seed=0)
    print(f"# lineitem sf={args.sf}: {li.num_rows} rows generated in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    mask = _q6_mask(li)
    print(f"# Q6 filter keeps {int(mask.sum())} rows", flush=True)

    sess = TorchSession({"spark.rapids.sql.test.enabled": True,
                         "spark.rapids.tpu.aqe.enabled": False})
    df = sess.create_dataframe(li, num_partitions=args.partitions)

    # -- Q6 phase: no hand-written kernel on this path ------------------------
    price = li.column("l_extendedprice").to_numpy()
    disc = li.column("l_discount").to_numpy()
    query_phase(tpch.q6({"lineitem": df}), "Q6", "revenue",
                float(np.sum(price[mask] * disc[mask])), launches=0)

    # -- UDF phase: one axpy launch per input batch --------------------------
    n = li.num_rows
    per = math.ceil(n / args.partitions)
    batches = sum(max(1, math.ceil(max(0, min(n, (p + 1) * per) - p * per)
                                   / (1 << 20)))
                  for p in range(args.partitions))
    f32 = {c: li.column(c).to_numpy().astype(np.float32)
           for c in ("l_discount", "l_extendedprice", "l_tax")}
    r = f32["l_discount"] * f32["l_extendedprice"] + f32["l_tax"]
    udf_q = df.filter(_q6_predicate(col, lit, dt)).agg(
        fsum(pallas_axpy(col("l_discount"), col("l_extendedprice"),
                         col("l_tax"))).alias("s"))
    launches = query_phase(udf_q, "UDF query", "s",
                           float(np.sum(r[mask].astype(np.float64))),
                           launches=batches)

    # -- Q1 phase: keyed aggregate over string keys, then a sort -----------
    q1_phase(tpch.q1({"lineitem": df}), li)

    # -- Q3 phase: equi-joins, top-n and AQE's broadcast demotion -----------
    t0 = time.perf_counter()
    tables = {"customer": tpch.gen_customer(args.q3_sf, seed=2),
              "orders": tpch.gen_orders(args.q3_sf, seed=1),
              "lineitem": li if args.q3_sf == args.sf
              else tpch.gen_lineitem(args.q3_sf, seed=0)}
    print(f"# Q3 tables sf={args.q3_sf}: " + ", ".join(
        f"{k} {v.num_rows} rows" for k, v in tables.items())
        + f", generated in {time.perf_counter() - t0:.2f} s", flush=True)
    q3_phase(tables, args.partitions)

    t = kern["timings"][1 << 20]
    print(json.dumps({"kernels": [{
        "name": "axpy", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/axpy.cu",
        "replaces": "spark_rapids_tpu/udf/examples.py:101",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
