"""The port's fault injection (utils/faults.py) against the JAX package's:
the spec grammar, the errors of bad specs, and the fire sequences of many
(spec, seed) pairs, which must equal the JAX ``FaultInjector``'s evaluation
for evaluation (both draw from ``random.Random(f"{seed}:{point}")``)."""
import random

import pytest

from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.utils import faults as jfaults

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _pristine():
    faults.reset_faults()
    faults.reset_recovery()
    yield
    faults.reset_faults()
    faults.reset_recovery()


def test_points_and_actions_equal_the_jax_catalogue():
    assert faults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert faults._ACTIONS == jfaults._ACTIONS
    assert faults._LEDGER_KEYS == jfaults._LEDGER_KEYS


def _specs():
    rng = random.Random(1234)
    out = ["alloc.jit:after=3:times=2:action=oom",
           "alloc.jit:after=2:times=2:action=fatal",
           "alloc.upload:times=3:action=oom",
           "spill.write:action=corrupt;spill.read:p=0.5",
           "h2d.upload:p=0.3:times=4, alloc.jit:p=0.7",
           "tcp.connect:p=0.2:times=3;worker.task:after=1:action=kill"]
    points = list(faults.FAULT_POINTS)
    for _ in range(14):
        clauses = []
        for p in rng.sample(points, rng.randint(1, 3)):
            kv = [p]
            if rng.random() < 0.7:
                kv.append(f"p={rng.choice([0.0, 0.1, 0.5, 0.9, 1.0])}")
            if rng.random() < 0.5:
                kv.append(f"times={rng.randint(0, 5)}")
            if rng.random() < 0.5:
                kv.append(f"after={rng.randint(0, 7)}")
            if rng.random() < 0.4:
                kv.append(f"action={rng.choice(faults._ACTIONS)}")
            clauses.append(":".join(kv))
        out.append(";".join(clauses))
    return out


@pytest.mark.parametrize("spec", _specs())
@pytest.mark.parametrize("seed", [0, 11, 97])
def test_fire_sequences_equal_jax(spec, seed):
    """One interleaving of point evaluations, replayed on both injectors:
    every decision (the action or None), the counters and the records
    equal."""
    port = faults.FaultInjector(spec, seed)
    jax_ = jfaults.FaultInjector(spec, seed)
    rng = random.Random(seed * 7 + len(spec))
    points = [c.split(":")[0].strip() for c in
              spec.replace(";", ",").split(",") if c.strip()]
    points += ["h2d.upload", "alloc.jit"]
    for _ in range(60):
        p = rng.choice(points)
        assert port.fire(p) == jax_.fire(p), p
    assert port.counters() == jax_.counters()
    assert port.drain_records() == jax_.drain_records()


def test_configure_through_the_conf_equals_jax():
    spec = "alloc.jit:after=1:times=2:action=oom"
    conf = {"spark.rapids.tpu.faults.enabled": True,
            "spark.rapids.tpu.faults.seed": 5,
            "spark.rapids.tpu.faults.spec": spec}
    inj = faults.configure_faults(RapidsConf(conf))
    jinj = jfaults.FaultInjector(spec, 5)
    try:
        assert faults.active() is inj and inj.seed == 5
        seq = [faults.fire("alloc.jit") for _ in range(5)]
        assert seq == [jinj.fire("alloc.jit") for _ in range(5)]
        assert seq == [None, "oom", "oom", None, None]
        # disabled: the module-level injector is None, fire() is a no-op
        assert faults.configure_faults(RapidsConf({})) is None
        assert faults.fire("alloc.jit") is None
    finally:
        jfaults.reset_faults()
    assert JConf({}).get(jfaults.FAULTS_ENABLED) is False


@pytest.mark.parametrize("bad,match", [
    ("alloc.jitt", "unknown fault point"),
    ("alloc.jit:p=1.5", r"not in \[0,1\]"),
    ("alloc.jit:times", "is not key=value"),
    ("alloc.jit:action=explode", "unknown fault action"),
    ("alloc.jit:speed=3", "unknown fault clause key"),
    ("alloc.jit:p=x", "could not convert"),
])
def test_bad_specs_raise_as_in_jax(bad, match):
    with pytest.raises(ValueError, match=match):
        faults.FaultInjector(bad)
    with pytest.raises(ValueError, match=match):
        jfaults.FaultInjector(bad)


def test_recovery_ledger_and_stats():
    faults.note_recovery("oom_retries")
    faults.note_recovery("oom_retries", 2)
    faults.note_recovery("brand_new_key")
    led = faults.recovery_counters()
    assert led["oom_retries"] == 3 and led["brand_new_key"] == 1
    assert led["host_fallbacks"] == 0
    faults.install(faults.FaultInjector("spill.read:times=1", 0))
    assert faults.fire("spill.read") == "raise"
    assert faults.faults_stats()["injected_spill_read"] == 1
    assert [r["point"] for r in faults.drain_fault_records()] == ["spill.read"]
    faults.reset_recovery()
    assert faults.recovery_counters()["oom_retries"] == 0


def test_latency_delays_then_returns_the_action():
    import time
    inj = faults.FaultInjector("h2d.upload:latency_ms=30:action=delay", 0)
    t0 = time.perf_counter()
    assert inj.fire("h2d.upload") == "delay"
    assert time.perf_counter() - t0 >= 0.025


def test_multi_gpu_points_are_accepted_and_never_evaluated():
    """Points the multi-GPU step reaches parse as in the JAX package. Its
    first half evaluates the shuffle's and the mesh stage's
    (``shuffle.fetch``, ``shuffle.publish``, ``mesh.dispatch``), and since
    its cross-process half the port evaluates the rest too (``tcp.*``,
    ``dcn.*``, ``worker.task``; tests/test_torch_tcp.py,
    test_torch_dcn.py and test_torch_process_cluster.py fire them): every
    point of the catalogue has a call site."""
    import pathlib
    inj = faults.FaultInjector("shuffle.fetch;tcp.read;dcn.fetch;"
                               "worker.task;mesh.dispatch", 0)
    assert set(inj.counters()) == {"shuffle.fetch", "tcp.read", "dcn.fetch",
                                   "worker.task", "mesh.dispatch"}
    root = pathlib.Path(faults.__file__).resolve().parent.parent
    fired = set()
    for path in root.rglob("*.py"):
        text = path.read_text()
        for p in faults.FAULT_POINTS:
            if f'fire("{p}")' in text or f"fault_point=\"{p}\"" in text:
                fired.add(p)
    assert fired == set(faults.FAULT_POINTS)
