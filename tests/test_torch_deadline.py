"""Query deadlines (utils/deadline.py) against the JAX package's: the scope
arms, fires once with one forensics dump and disarms; the error never
walks the retry ladder nor the host fallback; a query past
``query.timeoutSeconds`` cancels with ``QueryTimeoutError``, leaves no
semaphore holder and no engaged arbiter, and the same session then answers
again once the deadline is lifted."""
import json
import os
import time

import pytest

from spark_rapids_tpu.tools import tpch as jtpch
from spark_rapids_tpu.utils import deadline as jdeadline

from spark_rapids_tpu_torch.exec.fallback import classify_failure
from spark_rapids_tpu_torch.memory import retry
from spark_rapids_tpu_torch.memory.semaphore import peek_semaphore
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch
from spark_rapids_tpu_torch.utils import deadline, faults
from spark_rapids_tpu_torch.utils.deadline import (QueryTimeoutError,
                                                   check_deadline,
                                                   deadline_active,
                                                   deadline_scope)

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


@pytest.fixture(autouse=True)
def _pristine():
    deadline.reset_deadline()
    faults.reset_faults()
    yield
    deadline.reset_deadline()
    faults.reset_faults()


def test_scope_is_a_noop_at_zero():
    with deadline_scope(0.0):
        assert not deadline_active()
        check_deadline()
    assert deadline.deadline_stats()["deadlines_armed"] == 0


def test_scope_arms_fires_once_and_disarms(tmp_path):
    with pytest.raises(QueryTimeoutError) as ei:
        with deadline_scope(0.01, report_dir=str(tmp_path)):
            assert deadline_active()
            time.sleep(0.03)
            try:
                check_deadline()
            except QueryTimeoutError as first:
                with pytest.raises(QueryTimeoutError) as again:
                    check_deadline()
                assert again.value.forensics_path == first.forensics_path
                raise
    e = ei.value
    assert not deadline_active()
    assert e.timeout_s == pytest.approx(0.01) and e.elapsed_s >= 0.01
    assert e.forensics_path.startswith(str(tmp_path))
    dump = json.loads(open(e.forensics_path).read())
    assert set(dump) == {"ts", "timeout_s", "elapsed_s", "semaphore",
                         "oom_arbiter", "memprof_postmortem"}
    assert dump["oom_arbiter"]["active_retriers"] == 0
    s = deadline.deadline_stats()
    assert s == {"deadlines_armed": 1, "deadline_expiries": 1,
                 "deadline_armed": 0}


def test_message_and_fields_equal_jax():
    e = QueryTimeoutError(2.5, 3.25, "/x/y.json")
    j = jdeadline.QueryTimeoutError(2.5, 3.25, "/x/y.json")
    assert str(e) == str(j)
    assert (e.timeout_s, e.elapsed_s, e.forensics_path) \
        == (j.timeout_s, j.elapsed_s, j.forensics_path)


def test_the_timeout_is_no_oom_and_no_fallback():
    e = QueryTimeoutError(1.0, 2.0)
    assert not retry.is_retryable_oom(e)
    assert classify_failure(e) is None
    calls = []

    def fn():
        calls.append(1)
        raise e
    with pytest.raises(QueryTimeoutError):
        retry.with_retry(fn, scope="jit")
    assert calls == [1] and retry.retry_stats()["oom_retries"] == 0


def test_the_dump_goes_to_the_temp_dir_without_a_report_dir():
    import tempfile
    with pytest.raises(QueryTimeoutError) as ei:
        with deadline_scope(0.001):
            time.sleep(0.01)
            check_deadline()
    path = ei.value.forensics_path
    assert os.path.dirname(path) == tempfile.gettempdir()
    os.unlink(path)


def test_a_query_past_its_deadline_cancels_cleanly():
    """Q3 under ``timeoutSeconds=0.001`` raises QueryTimeoutError; no
    semaphore holder or waiter and no engaged arbiter remain, and the same
    session, its deadline lifted, answers Q6 right (JAX's answer)."""
    tables = jtpch.gen_all(0, tiny=True)
    sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 64,
                         "spark.rapids.tpu.query.timeoutSeconds": 0.001},
                        device="cpu")
    dfs = tpch.build_dataframes(sess, tables, num_partitions=2)
    with pytest.raises(QueryTimeoutError) as ei:
        tpch.q3(dfs).collect()
    assert ei.value.forensics_path
    os.unlink(ei.value.forensics_path)
    sem = peek_semaphore()
    assert sem is not None
    assert sem.holder_count() == 0 and sem.waiter_count() == 0
    arb = retry.arbiter_snapshot()
    assert arb["active_retriers"] == 0 and not arb["gate_active"]
    assert not deadline_active()
    sess.set_conf("spark.rapids.tpu.query.timeoutSeconds", 0.0)
    got = tpch.q6(dfs).collect()
    from spark_rapids_tpu.session import TpuSession
    want = jtpch.q6(jtpch.build_dataframes(
        TpuSession({"spark.rapids.tpu.batchRowsMinBucket": 64}), tables,
        num_partitions=2)).collect()
    assert_tables_equal(got, want)


def test_a_delayed_dispatch_times_out():
    """The JAX test's wedge: every dispatch delayed 300 ms past a 0.2 s
    deadline (``alloc.jit:action=delay:latency_ms=300``)."""
    tables = jtpch.gen_all(0, tiny=True)
    sess = TorchSession({
        "spark.rapids.tpu.batchRowsMinBucket": 64,
        "spark.rapids.tpu.query.timeoutSeconds": 0.2,
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.spec":
            "alloc.jit:action=delay:latency_ms=300"}, device="cpu")
    dfs = tpch.build_dataframes(sess, tables, num_partitions=2)
    with pytest.raises(QueryTimeoutError) as ei:
        tpch.q1(dfs).collect()
    assert ei.value.timeout_s == pytest.approx(0.2)
    os.unlink(ei.value.forensics_path)
    assert peek_semaphore().holder_count() == 0
