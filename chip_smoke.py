#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--partitions 2]

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

Any mismatch raises and the script exits non-zero. The line before the last
is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
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

    sess = TorchSession({"spark.rapids.sql.test.enabled": True})
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
