"""The port's runtime degradation layer (exec/fallback.py) against the JAX
package's: the classification table (CUDA classes in place of XLA's, sticky
CUDA errors and a hand-written kernel's build, load or launch failures
re-raised), the quarantine store (entries, TTL and eviction equal to the
JAX store's after the same notes, kept for the process only), the host
fallback under ``action=fatal`` (answers equal to the clean ones), and the
plan-time quarantine routing and its ``explain`` reasons."""
import re

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import fallback as jfb
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import fallback as fb
from spark_rapids_tpu_torch.memory import retry
from spark_rapids_tpu_torch.memory.retry import (DeviceOomError,
                                                 InjectedDeviceFailure)
from spark_rapids_tpu_torch.native import KernelBuildError
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch
from spark_rapids_tpu_torch.utils import faults
from spark_rapids_tpu_torch.utils.deadline import QueryTimeoutError

from harness import assert_tables_equal


@pytest.fixture(autouse=True)
def _jax_bucket_policy():
    """A JAX session sets the JAX package's process-wide bucket ladder
    (``configure_buckets``) for every later JAX call in the process; this
    file's sessions put it back as they found it."""
    from spark_rapids_tpu.columnar import device as jdev
    saved = jdev._POLICY
    yield
    jdev._POLICY = saved


def _reset():
    fb.reset_fallback_state()
    fb.configure_fallback(RapidsConf({}))
    jfb.reset_fallback_state()
    jfb.configure_fallback(JConf({}))
    retry.reset_retry_state()
    retry.configure_oom_retry(RapidsConf({}))
    faults.reset_faults()
    faults.reset_recovery()


@pytest.fixture(autouse=True)
def _pristine():
    _reset()
    yield
    _reset()


@pytest.mark.parametrize("exc,cls", [
    # the port's own faults on the card: a launch configuration, a dtype
    # an operation lacks, a generic runtime error -- never hidden
    (RuntimeError("CUDA error: invalid argument\nCUDA kernel errors might "
                  "be asynchronously reported"), None),
    (RuntimeError("CUDA error: invalid configuration argument"), None),
    (RuntimeError('"cummin_cuda" not implemented for \'Bool\''), None),
    (RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling "
                  "cublasGemmEx"), None),
    (RuntimeError("cuDNN error: CUDNN_STATUS_INTERNAL_ERROR"), None),
    (RuntimeError("CUDA error: operation failed due to a previous error"),
     None),
    (InjectedDeviceFailure("CUDA error: injected non-retryable device "
                           "failure at alloc.jit (faults action=fatal)"),
     "cuda_internal"),
    (DeviceOomError("ladder exhausted"), "oom_exhausted"),
    (RuntimeError("CUDA out of memory. Tried to allocate 1 GiB"), "oom"),
    # sticky: the context is lost, never a fallback
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     None),
    (RuntimeError("CUDA error: device-side assert triggered"), None),
    (RuntimeError("CUDA error: unspecified launch failure"), None),
    (RuntimeError("CUDA error: misaligned address"), None),
    # a hand-written kernel's own failures: never hidden
    (KernelBuildError("nvcc failed (2): ..."), None),
    (KernelBuildError("cannot load libsrt_kernels.so"), None),
    (RuntimeError("nfa_match kernel launch failed: CUDA error 9"), None),
    (RuntimeError("d128_rescale kernel launch failed: CUDA error 1"), None),
    # cancellation and host errors
    (QueryTimeoutError(0.1, 0.2), None),
    (ValueError("CUDA error: invalid argument"), None),
    (RuntimeError("some host bug"), None),
    (RuntimeError("CUDA error: too many resources requested for launch"),
     None),
    # a CUDA library that could not allocate its workspace
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                  "cublasCreate(handle)"), "cuda_library"),
    (RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"), "cuda_library"),
])
def test_classification_table(exc, cls):
    assert fb.classify_failure(exc) == cls


def test_a_ladder_ended_by_a_sticky_error_is_not_eligible():
    try:
        try:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        except RuntimeError as inner:
            raise DeviceOomError("exhausted") from inner
    except DeviceOomError as e:
        assert fb.classify_failure(e) is None


def test_the_xla_classes_have_cuda_counterparts():
    """The JAX package's table, class for class, and the port's
    counterparts: XLA's invalid-argument, unimplemented and compile
    failures have none (a torch call on the card that raises one of those
    is the port's own fault and re-raises; nothing is compiled), its
    internal failure is the injected ``action=fatal`` alone, and CUDA
    libraries' allocation failures are named statuses."""
    assert [c for _, c in jfb._XLA_CLASSES] == [
        "xla_invalid_argument", "xla_unimplemented", "xla_compile",
        "xla_compile", "xla_internal"]
    assert {c for _, c in fb._CUDA_CLASSES} == {"cuda_library"}
    assert all(m.endswith("ALLOC_FAILED") for m, _ in fb._CUDA_CLASSES)
    assert fb.classify_failure(InjectedDeviceFailure("x")) == "cuda_internal"
    assert fb.classify_failure(RuntimeError("CUDA error: x")) is None


class _Node:
    def __init__(self, name="Node"):
        self.name = name

    def plan_signature(self):
        return f"sig|{self.name}"

    def node_desc(self):
        return self.name


class _Batch:
    """A stand-in device batch: to_host() gives a host table."""
    device = None

    def __init__(self, t):
        self.t = t

    def to_host(self):
        from spark_rapids_tpu_torch.columnar.host import HostTable
        return HostTable.from_arrow(self.t)


def test_sticky_and_kernel_errors_re_raise_through_the_boundary():
    for exc in (RuntimeError("CUDA error: device-side assert triggered"),
                KernelBuildError("nvcc failed (1)"),
                RuntimeError("seg_scan kernel launch failed: CUDA error 2")):
        def device_fn(b, exc=exc):
            raise exc
        run = fb.with_host_fallback(_Node(), device_fn, lambda t: t)
        with pytest.raises(type(exc)):
            run(_Batch(pa.table({"a": [1]})))
    s = fb.fallback_stats()
    assert s["host_fallbacks"] == 0 and s["quarantine_notes"] == 0


def test_fallback_runs_the_host_twin_loudly(capsys):
    import torch
    t = pa.table({"a": [1, 2, 3]})

    def device_fn(b):
        raise InjectedDeviceFailure("CUDA error: injected")

    class B(_Batch):
        device = torch.device("cpu")
    run = fb.with_host_fallback(_Node("Proj"), device_fn,
                                lambda ht: ht.take(np.array([0, 2])))
    out = run(B(t))
    assert out.to_host().to_arrow().column("a").to_pylist() == [1, 3]
    assert "re-executed on the host engine" in capsys.readouterr().err
    assert fb.fallback_stats()["host_fallbacks"] == 1
    assert faults.recovery_counters()["host_fallbacks"] == 1
    (rec,) = fb.drain_fallback_records()
    assert rec["failure_class"] == "cuda_internal" and rec["rows"] == 2
    (ent,) = fb.quarantine_entries()
    assert ent["operator"] == "_Node" and ent["count"] == 1


def _notes():
    rng = np.random.default_rng(9)
    ops = ["TpuProjectExec", "TpuFilterExec", "TpuHashAggregateExec",
           "TpuSortExec"]
    return [(ops[rng.integers(0, 4)], f"sig{rng.integers(0, 3)}",
             ["oom_exhausted", "cuda_internal"][rng.integers(0, 2)],
             f"Reason {i}") for i in range(40)]


def _strip(entries):
    return sorted((e["operator"], e["sig_hash"], e["failure_class"],
                   e["count"], e["reason"]) for e in entries)


@pytest.mark.parametrize("max_entries,threshold", [(256, 3), (5, 1),
                                                   (2, 2)])
def test_quarantine_store_equals_jax(monkeypatch, max_entries, threshold):
    """The same notes, at the same clock, in both stores: the same entries
    survive, the same reasons come out of ``quarantine_reason``, and the
    TTL expires the same ones."""
    clock = [1000.0]
    monkeypatch.setattr(fb.time, "time", lambda: clock[0])
    monkeypatch.setattr(jfb.time, "time", lambda: clock[0])
    conf = {"spark.rapids.tpu.fallback.quarantine.maxEntries": max_entries,
            "spark.rapids.tpu.fallback.quarantine.threshold": threshold,
            "spark.rapids.tpu.fallback.quarantine.ttlSeconds": 50.0}
    fb.configure_fallback(RapidsConf(conf))
    jfb.configure_fallback(JConf(conf))
    for op, sig, cls, reason in _notes():
        clock[0] += 1.0
        fb.note_quarantine(op, sig, cls, reason)
        jfb.note_quarantine(op, sig, cls, reason)
    assert _strip(fb.quarantine_entries()) == _strip(jfb.quarantine_entries())
    for op in ("TpuProjectExec", "TpuFilterExec", "TpuHashAggregateExec",
               "TpuSortExec"):
        for sig in ("sig0", "sig1", "sig2"):
            assert fb.quarantine_reason(op, sig) \
                == jfb.quarantine_reason(op, sig)
    clock[0] += 30.0
    assert fb.quarantine_reason("TpuSortExec", "sig0") \
        == jfb.quarantine_reason("TpuSortExec", "sig0")
    assert _strip(fb.quarantine_entries()) == _strip(jfb.quarantine_entries())
    assert fb.fallback_stats()["quarantine_notes"] == 40


def test_quarantine_store_lives_for_the_process_only():
    """The JAX store persists as quarantine.json beside its compile cache's
    manifest; the port has no such cache, so its store is session-only
    state of the process: nothing to persist or load."""
    assert not hasattr(fb, "persist_quarantine")
    assert not hasattr(fb._QuarantineStore, "persist")
    assert not hasattr(fb._QuarantineStore, "load")
    fb.note_quarantine("TpuSortExec", "s", "oom", "r")
    TorchSession(device="cpu")   # a new session reads nothing from disk
    assert len(fb.quarantine_entries()) == 1
    fb.reset_fallback_state()
    TorchSession(device="cpu")
    assert fb.quarantine_entries() == []


_BASE = {"spark.rapids.tpu.batchRowsMinBucket": 64}


@pytest.fixture(scope="module")
def tables():
    return jtpch.gen_all(0, tiny=True)


def _q(name, tables, conf):
    sess = TorchSession({**_BASE, **conf}, device="cpu")
    q = getattr(tpch, name)(tpch.build_dataframes(sess, tables,
                                                  num_partitions=2))
    return sess, q


@pytest.mark.parametrize("name", ["q1", "q6", "q3"])
def test_fatal_failures_fall_back_to_the_clean_answer(tables, name):
    """``bench.py _worker_fallback``'s contract: under the JAX test's
    ``alloc.jit:times=2:action=fatal`` (seed 11) the two failed batches,
    both in the first fused stage, rerun on the host engine, and the answer
    equals the clean run's and the JAX package's. (At this size a later
    evaluation lands in an aggregate, whose state spans batches and which
    can only quarantine, as in the JAX package; chip_smoke.py's SF1 run
    takes ``after=2``, still inside the first stage's batches.)"""
    _, q = _q(name, tables, {})
    clean = q.collect()
    _, q = _q(name, tables, {
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.seed": 11,
        "spark.rapids.tpu.faults.spec": "alloc.jit:times=2:action=fatal",
        "spark.rapids.tpu.fallback.quarantine.threshold": 1000})
    got = q.collect()
    faults.reset_faults()
    assert_tables_equal(got, clean, ignore_order=False)
    from spark_rapids_tpu.session import TpuSession
    want = getattr(jtpch, name)(jtpch.build_dataframes(
        TpuSession(_BASE), tables, num_partitions=2)).collect()
    assert_tables_equal(got, want, ignore_order=name != "q1")
    s = fb.fallback_stats()
    assert s["host_fallbacks"] == 2
    recs = fb.drain_fallback_records()
    assert [r["failure_class"] for r in recs] == ["cuda_internal"] * 2
    assert retry.retry_stats()["oom_retries"] == 0


def test_ladder_exhaustion_falls_back(tables):
    """With the ladder shut (maxRetries=0, maxSplits=0) an injected OOM ends
    in DeviceOomError, which the boundary takes as ``oom_exhausted``."""
    _, q = _q("q6", tables, {})
    clean = q.collect()
    _, q = _q("q6", tables, {
        "spark.rapids.tpu.oom.maxRetries": 0,
        "spark.rapids.tpu.oom.maxSplits": 0,
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.spec": "alloc.jit:times=1:action=oom"})
    got = q.collect()
    assert_tables_equal(got, clean)
    recs = fb.drain_fallback_records()
    assert recs and all(r["failure_class"] == "oom_exhausted" for r in recs)


def _explain_reasons(text):
    return sorted(re.findall(r"! (\w+) cannot run on (?:the device|TPU) "
                             r"because quarantined: (\d+) runtime (\w+) "
                             r"failure", text))


def test_quarantine_routes_to_the_host_and_explain_says_so(tables):
    """Past the threshold, explain shows the quarantine reasons at the
    nodes the JAX package shows them (the chain members of the failed
    stage, with the same counts; the class is CUDA's, not XLA's), and a
    new plan runs them on the host with no fallback."""
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.utils import faults as jfaults
    thr = {"spark.rapids.tpu.fallback.quarantine.threshold": 2}
    sess, q = _q("q6", tables, thr)
    clean = q.collect()
    spec = "alloc.jit:times=2:action=fatal"
    _, q = _q("q6", tables, {**thr, "spark.rapids.tpu.faults.enabled": True,
                             "spark.rapids.tpu.faults.spec": spec})
    assert_tables_equal(q.collect(), clean)
    faults.reset_faults()
    sess, q = _q("q6", tables, thr)
    text = q.explain("device")
    # the JAX package, the same run
    jsess = TpuSession({**_BASE, **thr})
    jq = jtpch.q6(jtpch.build_dataframes(jsess, tables, num_partitions=2))
    jq.collect(device=True)
    jfaults.configure_faults(JConf({"spark.rapids.tpu.faults.enabled": True,
                                    "spark.rapids.tpu.faults.spec": spec}))
    jq.collect(device=True)
    jfaults.reset_faults()
    jtext = jq.explain("tpu")
    port = _explain_reasons(text)
    jax_ = _explain_reasons(jtext)
    assert port and [(n, c) for n, c, _ in port] \
        == [(n, c) for n, c, _ in jax_]
    assert {k for _, _, k in port} == {"cuda_internal"}
    assert {k for _, _, k in jax_} == {"xla_internal"}
    before = fb.fallback_stats()
    got = q.collect()
    assert_tables_equal(got, clean)
    after = fb.fallback_stats()
    assert after["quarantine_plan_routes"] > before["quarantine_plan_routes"]
    assert after["host_fallbacks"] == before["host_fallbacks"]
    # test.enabled: a quarantined node is deliberate host routing
    sess2, q2 = _q("q6", tables, {**thr, "spark.rapids.sql.test.enabled":
                                  True})
    assert_tables_equal(q2.collect(), clean)


def test_kernel_bearing_expressions_and_nodes():
    """``runs_kernel`` marks exactly the expressions whose device
    evaluation calls a kernel's wrapper, and the nodes evaluating them."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.expr.arithmetic import Multiply
    from spark_rapids_tpu_torch.expr.base import AttributeReference
    from spark_rapids_tpu_torch.expr.cast import Cast
    from spark_rapids_tpu_torch.expr.functions import col
    from spark_rapids_tpu_torch.udf.examples import pallas_axpy

    def ref(t):
        return AttributeReference("a", t)
    d12, d13 = dt.DecimalType(12, 2), dt.DecimalType(13, 2)
    d5, d30 = dt.DecimalType(5, 2), dt.DecimalType(30, 2)
    assert col("s").like("%green%blue%").expr.runs_kernel()
    assert col("s").like("a_c").expr.runs_kernel()
    for simple in ("%green%", "green%", "%green", "green"):
        assert not col("s").like(simple).expr.runs_kernel()
    assert Multiply(ref(d12), ref(d13)).coerce().runs_kernel()
    assert not Multiply(ref(d5), ref(d5)).coerce().runs_kernel()
    assert not Multiply(ref(dt.DOUBLE), ref(dt.DOUBLE)).runs_kernel()
    assert Cast(ref(dt.LONG), d30).runs_kernel()
    assert Cast(ref(d12), d30).runs_kernel()
    assert Cast(ref(d30), d12).runs_kernel()
    assert not Cast(ref(d12), dt.DecimalType(14, 2)).runs_kernel()
    assert not Cast(ref(dt.DOUBLE), d30).runs_kernel()
    assert not Cast(ref(d30), dt.DOUBLE).runs_kernel()
    udf = pallas_axpy(col("a"), col("b"), col("c")).expr
    assert udf.runs_kernel()
    # a kernel anywhere under the root marks the tree
    from spark_rapids_tpu_torch.expr.predicates import Not
    assert Not(col("s").like("%a%b%").expr).tree_runs_kernel()
    assert not Not(col("s").like("%a%").expr).tree_runs_kernel()


def _like_query(sess, tables):
    from spark_rapids_tpu_torch.expr.functions import col
    part = tpch.build_dataframes(sess, tables, num_partitions=2)["part"]
    return part.filter(col("p_name").like("%green%l%")).select(
        "p_partkey", "p_name")


def _q1_decimal(sess, tables):
    li = tpch.decimal_lineitem(tables["lineitem"])
    return tpch.q1_decimal({"lineitem": sess.create_dataframe(
        li, num_partitions=2)})


@pytest.mark.parametrize("query", ["q1_decimal", "like_filter"])
def test_a_kernel_bearing_stage_never_falls_back(tables, query):
    """A batch that may call a hand-written kernel (Q1 decimal's
    ``d128_mul_rescaled``/``d128_rescale``/``d128_segment_sum``, a LIKE on
    ``nfa_match``) is never rerun on the host: ``action=fatal`` re-raises,
    nothing is noted in the quarantine store, and so no later plan routes
    the operator to the host either, however often it fails."""
    build = _q1_decimal if query == "q1_decimal" else _like_query
    conf = {**_BASE, "spark.rapids.tpu.fallback.quarantine.threshold": 1}
    clean = build(TorchSession(conf, device="cpu"), tables).collect()
    assert clean.num_rows
    fatal = {**conf, "spark.rapids.tpu.faults.enabled": True,
             "spark.rapids.tpu.faults.spec": "alloc.jit:times=1:action=fatal"}
    for _ in range(3):
        with pytest.raises(InjectedDeviceFailure):
            build(TorchSession(fatal, device="cpu"), tables).collect()
    faults.reset_faults()
    s = fb.fallback_stats()
    assert s["host_fallbacks"] == 0 and s["quarantine_notes"] == 0
    assert fb.quarantine_entries() == []
    q = build(TorchSession(conf, device="cpu"), tables)
    assert "quarantined" not in q.explain("device")
    assert_tables_equal(q.collect(), clean, ignore_order=False)
    assert fb.fallback_stats()["quarantine_plan_routes"] == 0


def test_the_plan_pass_never_routes_a_kernel_bearing_node(tables):
    """Even with the store holding a kernel-bearing node's key past the
    threshold, the planner's quarantine pass leaves the node on the
    device."""
    from spark_rapids_tpu_torch.exec.basic import TpuFilterExec
    conf = {**_BASE, "spark.rapids.tpu.fallback.quarantine.threshold": 1,
            "spark.rapids.sql.test.enabled": True}
    sess = TorchSession(conf, device="cpu")
    q = _like_query(sess, tables)
    clean = q.collect()
    filters = {}

    def walk(n):
        if isinstance(n, TpuFilterExec):
            filters[id(n)] = n
        for c in getattr(n, "chain", ()) or ():
            walk(c)
        for c in getattr(n, "children", ()):
            walk(c)
    walk(sess._physical(q.logical, True))
    (flt,) = filters.values()
    assert flt.runs_kernel()
    fb.note_quarantine("TpuFilterExec", flt.plan_signature(), "oom",
                       "planted")
    assert fb.quarantine_reason("TpuFilterExec", flt.plan_signature())
    q = _like_query(TorchSession(conf, device="cpu"), tables)
    assert "quarantined" not in q.explain("device")
    assert_tables_equal(q.collect(), clean, ignore_order=False)
    assert fb.fallback_stats()["quarantine_plan_routes"] == 0
