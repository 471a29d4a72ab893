"""Typed configuration — the port's copy of ``spark_rapids_tpu/conf.py``
with only the keys this engine reads.

A typed registry of ``spark.rapids.*`` entries with docs, defaults and
validators (reference: ``RapidsConf.scala``, builder DSL at lines 121-299).
Keys keep the JAX package's names so a configuration carries over: every
key the JAX package registers is either read here or registered with the
JAX default, and any other value raises, naming the ROADMAP Queue 1 step
that will read it (``_UNREAD_BY_STEP``), by the step's name, which a
re-anchor of the ROADMAP does not change. Keys the JAX package does not
register either (the per-op enable keys among them) are kept as given.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = ["ConfEntry", "RapidsConf", "register_conf", "not_ported"]

_REGISTRY: "Dict[str, ConfEntry]" = {}

#: The open steps of ROADMAP Queue 1, by name: messages name the step that
#: will port a feature by these, never by a number a re-anchor changes.
STEP_DECIMAL128 = "decimal128"
STEP_RELATIONAL = "the relational surface"
STEP_NESTED_LOOP = "nested-loop and cross joins"
STEP_ROBUSTNESS = "memory and robustness"
STEP_MULTI_GPU = "multi-GPU"
STEP_BREADTH = "breadth"


def not_ported(step: str) -> str:
    """The tail of a "not ported yet" message: ``(ROADMAP Queue 1:
    <step>)``."""
    return f"(ROADMAP Queue 1: {step})"


class ConfEntry:
    """One typed config entry (reference ConfEntry/ConfBuilder, RapidsConf.scala:121-175)."""

    def __init__(self, key: str, doc: str, default: Any, conf_type: type,
                 checker: Optional[Callable[[Any], Optional[str]]] = None):
        self.key = key
        self.doc = doc
        self.default = default
        self.conf_type = conf_type
        self.checker = checker

    def convert(self, raw: Any) -> Any:
        if raw is None:
            return self.default
        if self.conf_type is bool:
            if isinstance(raw, bool):
                v: Any = raw
            else:
                s = str(raw).strip().lower()
                if s in ("true", "1", "yes", "on"):
                    v = True
                elif s in ("false", "0", "no", "off"):
                    v = False
                else:
                    raise ValueError(f"{self.key}: cannot parse boolean from {raw!r}")
        elif self.conf_type in (int, float, str):
            v = self.conf_type(raw)
        else:
            v = raw
        if self.checker is not None:
            try:
                err = self.checker(v)
            except NotImplementedError as e:
                raise NotImplementedError(f"{self.key}={raw!r}: {e}") from None
            if err:
                raise ValueError(f"{self.key}: {err}")
            normalize = getattr(self.checker, "normalize", None)
            if normalize is not None and isinstance(v, str):
                v = normalize(v)
        return v


def register_conf(key: str, doc: str, default: Any,
                  conf_type: Optional[type] = None,
                  checker: Optional[Callable[[Any], Optional[str]]] = None
                  ) -> ConfEntry:
    if conf_type is None:
        conf_type = type(default) if default is not None else str
    entry = ConfEntry(key, doc, default, conf_type, checker)
    _REGISTRY[key] = entry
    return entry


def _positive(what: str):
    def check(v):
        return None if v > 0 else f"{what} must be positive, got {v}"
    return check


SQL_ENABLED = register_conf(
    "spark.rapids.sql.enabled",
    "Enable (true) or disable (false) lowering query plans onto the device. "
    "(reference: RapidsConf.scala SQL_ENABLED)", True)

SQL_EXPLAIN = register_conf(
    "spark.rapids.sql.explain",
    "NONE, ALL, or NOT_ON_GPU: when to print plan-tagging explain output.",
    "NONE", checker=lambda v: None if v in ("NONE", "ALL", "NOT_ON_GPU")
    else f"must be one of NONE, ALL, NOT_ON_GPU, got {v!r}")

BATCH_ROWS_MIN_BUCKET = register_conf(
    "spark.rapids.tpu.batchRowsMinBucket",
    "Smallest row-capacity bucket for device batches. Row counts are padded "
    "up to power-of-two multiples of this, so operators see a bounded set "
    "of shapes.", 1024, checker=_positive("bucket"))

BATCH_SIZE_BYTES = register_conf(
    "spark.rapids.sql.batchSizeBytes",
    "Target device batch size in bytes: a join build side over it takes "
    "the grace join, and a sort whose input batches exceed it together "
    "takes the out-of-core sort. (reference: RapidsConf.scala:425-432)",
    512 * 1024 * 1024, checker=_positive("batch size"))

SHUFFLE_PARTITIONS = register_conf(
    "spark.rapids.tpu.shuffle.partitions",
    "Number of output partitions for hash/range exchanges (Spark's "
    "spark.sql.shuffle.partitions analogue).", 8,
    checker=_positive("partition count"))

TEST_ENABLED = register_conf(
    "spark.rapids.sql.test.enabled",
    "Fail if a query does not fully run on device, scans and exchanges "
    "excepted (reference: RapidsConf.scala:968-989).", False)

BROADCAST_THRESHOLD = register_conf(
    "spark.rapids.tpu.autoBroadcastJoinThreshold",
    "Max estimated build-side bytes for broadcast hash join planning "
    "(Spark's spark.sql.autoBroadcastJoinThreshold analogue; -1 disables).",
    10 * 1024 * 1024)

JOIN_STRATEGY = register_conf(
    "spark.rapids.tpu.join.strategy",
    "Unique-build-key (FK->PK) join algorithm: 'sort' (sorted build keys "
    "+ searchsorted), 'hash' (open-addressing slot table) or 'auto' "
    "(= hash). Non-unique builds always take the sorted count/expand path.",
    "auto", checker=lambda v: None if str(v).lower() in ("auto", "sort", "hash")
    else "must be auto|sort|hash")

def _not_ported_unless_default(default: Any, step: str,
                               case_free: bool = False
                               ) -> Callable[[Any], Optional[str]]:
    """Checker of a conf the engine does not read yet: the default is what
    it runs, any other value (compared after the entry's type conversion,
    and in lower case where ``case_free``) raises naming the ROADMAP step
    that reads it, so a setting is never silently ignored."""
    def check(v: Any) -> Optional[str]:
        if (v.lower() if case_free else v) != default:
            raise NotImplementedError(
                f"a value other than {default!r} is not ported yet "
                f"{not_ported(step)}")
        return None
    if case_free:
        # convert() stores the value in lower case, as the JAX entry does
        check.normalize = str.lower
    return check


AQE_ENABLED = register_conf(
    "spark.rapids.tpu.aqe.enabled",
    "Adaptive query execution: re-plan at exchange boundaries using runtime "
    "partition statistics (join demotion to broadcast, partition coalescing, "
    "skew-join splitting). Spark's spark.sql.adaptive.enabled analogue.",
    True)

register_conf(
    "spark.rapids.tpu.aqe.advisoryPartitionSizeBytes",
    "Target bytes per shuffle partition after AQE coalescing "
    "(spark.sql.adaptive.advisoryPartitionSizeInBytes analogue).",
    64 * 1024 * 1024,
    checker=_not_ported_unless_default(64 * 1024 * 1024, STEP_MULTI_GPU))

AQE_COALESCE_ENABLED = register_conf(
    "spark.rapids.tpu.aqe.coalescePartitions.enabled",
    "Merge adjacent small shuffle partitions toward the advisory size "
    "(spark.sql.adaptive.coalescePartitions.enabled analogue). Not ported "
    f"yet {not_ported(STEP_MULTI_GPU)}: a stage of more than one partition "
    "is left as it is, and AdaptiveExec.events says so.", True)

register_conf(
    "spark.rapids.tpu.aqe.coalescePartitions.minPartitionNum",
    "Lower bound on the partition count coalescing may produce.", 1,
    checker=_not_ported_unless_default(1, STEP_MULTI_GPU))

AQE_BROADCAST_BYTES = register_conf(
    "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold",
    "Max materialized build-side bytes for AQE join demotion to broadcast; "
    "-1 disables demotion (spark.sql.adaptive + autoBroadcastJoinThreshold).",
    10 * 1024 * 1024)

AQE_SKEW_ENABLED = register_conf(
    "spark.rapids.tpu.aqe.skewJoin.enabled",
    "Split skewed probe-side partitions of shuffled hash joins "
    "(spark.sql.adaptive.skewJoin.enabled analogue). Not ported yet "
    f"{not_ported(STEP_MULTI_GPU)}: a stage of more than one partition is "
    "left as it is, and AdaptiveExec.events says so.", True)

register_conf(
    "spark.rapids.tpu.aqe.skewJoin.skewedPartitionFactor",
    "A partition is skewed when its bytes exceed this multiple of the "
    "median partition size (and the threshold below).", 5,
    checker=_not_ported_unless_default(5, STEP_MULTI_GPU))

register_conf(
    "spark.rapids.tpu.aqe.skewJoin.skewedPartitionThresholdBytes",
    "Minimum bytes for a partition to be considered skewed.",
    256 * 1024 * 1024,
    checker=_not_ported_unless_default(256 * 1024 * 1024,
                                       STEP_MULTI_GPU))

AQE_RUNTIME_FILTER = register_conf(
    "spark.rapids.tpu.aqe.runtimeFilter.enabled",
    "When a join demotes to broadcast, push the build side's distinct join "
    "keys into the probe side's host scan as an IN filter (the dynamic-"
    "partition-pruning analogue: the Parquet reader skips row groups whose "
    "statistics exclude every build key). A source without statistics "
    "(the in-memory one) takes none, as in the JAX package.", True)

AQE_RUNTIME_FILTER_MAX_KEYS = register_conf(
    "spark.rapids.tpu.aqe.runtimeFilter.maxKeys",
    "Skip the runtime IN-filter when the build side has more distinct keys "
    "than this.", 10_000)

# -- the scan layer: the upload cache, coalescing and bulk downloads -------
SCAN_DEVICE_CACHE = register_conf(
    "spark.rapids.tpu.scan.deviceCache.enabled",
    "Keep uploaded scan batches device-resident across executions: a source "
    "that re-yields the same host batch (the in-memory source caches its "
    "decoded batches) skips the host->device upload. An entry dies with "
    "its host batch. (reference: ParquetCachedBatchSerializer keeps "
    "Spark-cached data as device batches)", True)

SCAN_DEVICE_CACHE_MAX_BYTES = register_conf(
    "spark.rapids.tpu.scan.deviceCache.maxBytes",
    "Device-byte budget for the scan upload cache; uploads past the budget "
    "are not cached (data still flows, uncached). 0 disables caching.",
    2 << 30)

COALESCE_AFTER_UPLOAD = register_conf(
    "spark.rapids.tpu.coalesce.afterUpload.enabled",
    "Insert a TpuCoalesceBatchesExec above every host->device upload so "
    "many small scanned batches stitch into full-size device batches "
    "before compute (reference: GpuCoalesceBatches above GpuRowToColumnar "
    "via childrenCoalesceGoal).", False)

COALESCE_TARGET_BYTES = register_conf(
    "spark.rapids.tpu.coalesce.targetBytes",
    "Byte-based flush target for TpuCoalesceBatchesExec, alongside the "
    "row goal: a pending set flushes once its device bytes reach this "
    "bound even when the row target is far away (reference: the TargetSize "
    "coalesce goal, GpuCoalesceBatches.scala:93-200). 0 disables the byte "
    "bound.", 512 * 1024 * 1024,
    checker=lambda v: None if int(v) >= 0 else "must be >= 0")

ASYNC_ENABLED = register_conf(
    "spark.rapids.tpu.async.enabled",
    "The device->host drain accumulates a partition's device batches and "
    "downloads them in one copy per plane type (columnar/device.py "
    "to_host_batched). 'false' downloads each batch on its own as it "
    "arrives.", True)

# -- the Parquet scan ------------------------------------------------------
PARQUET_DEVICE_DECODE = register_conf(
    "spark.rapids.tpu.parquet.deviceDecode.enabled",
    "Decode supported parquet columns on the device (run-table expansion "
    "and dictionary gather kernels; reference: GpuParquetScanBase device "
    "decode). Unsupported columns fall back to host decode per column.",
    True)

PARQUET_DEVICE_DECODE_STRINGS = register_conf(
    "spark.rapids.tpu.parquet.deviceDecode.strings.enabled",
    "Decode BYTE_ARRAY (string/binary) parquet columns on device; false "
    "keeps strings on the per-column host decode.", True)

PARQUET_DEVICE_DECODE_BOOLEANS = register_conf(
    "spark.rapids.tpu.parquet.deviceDecode.booleans.enabled",
    "Decode BOOLEAN parquet columns on device; false keeps booleans on "
    "the per-column host decode.", True)

PARQUET_READER_TYPE = register_conf(
    "spark.rapids.sql.format.parquet.reader.type",
    "PERFILE, COALESCING or MULTITHREADED parquet reader strategy "
    "(reference: RapidsConf.scala:721).", "COALESCING",
    checker=lambda v: None if v in ("PERFILE", "COALESCING",
                                    "MULTITHREADED", "AUTO")
    else f"must be one of PERFILE, COALESCING, MULTITHREADED, AUTO, "
    f"got {v!r}")

MULTITHREAD_READ_NUM_THREADS = register_conf(
    "spark.rapids.sql.multiThreadedRead.numThreads",
    "Thread pool size for the MULTITHREADED file reader and the device "
    "scan's file read-ahead (reference: GpuParquetScanBase.scala:934).", 8,
    checker=_positive("threads"))

READER_BATCH_SIZE_ROWS = register_conf(
    "spark.rapids.sql.reader.batchSizeRows",
    "Soft cap on rows per batch produced by file scans (reference: "
    "RapidsConf READER_BATCH_SIZE_ROWS).", 1 << 21,
    checker=_positive("reader batch rows"))

SCAN_PUSHDOWN = register_conf(
    "spark.rapids.tpu.scan.filterPushdown.enabled",
    "Push translatable Filter conjuncts into parquet scans (row-group "
    "statistics pruning in the host reader). The full filter stays in the "
    "plan; a scan with a pushed filter stays on the host reader.", True)


# -- the spill catalog (memory/catalog.py) ---------------------------------
HOST_SPILL_STORAGE_SIZE = register_conf(
    "spark.rapids.memory.host.spillStorageSize",
    "Bytes of host memory used to spill device buffers before disk. "
    "(reference: RapidsConf.scala:363)", 1024 * 1024 * 1024,
    checker=_positive("spill storage"))

OOM_SPILL_ENABLED = register_conf(
    "spark.rapids.memory.gpu.oomSpill.enabled",
    "Spill lowest-priority buffers when the device budget is exceeded "
    "(reference: DeviceMemoryEventHandler).", True)

DISK_SPILL_DIRECT = register_conf(
    "spark.rapids.tpu.memory.disk.direct",
    "Restore disk-spilled buffers through read-only memory maps copied "
    "straight to the device (the GPUDirect-Storage analogue; reference: "
    "RapidsGdsStore). false uses compact npz files.", True)

DISK_SPILL_CHECKSUM = register_conf(
    "spark.rapids.tpu.memory.disk.checksum",
    "CRC32-checksum disk-spilled buffers on write and verify them on "
    "restore; a mismatch raises SpillCorruptionError instead of serving "
    "silently corrupt rows.", True)


#: Every key the JAX package registers that this engine does not read yet,
#: with the JAX default, by the ROADMAP Queue 1 step that will read it. The
#: port keeps its own copy (it imports nothing of the JAX package);
#: tests/test_torch_conf.py holds it equal to the JAX registry.
_UNREAD_BY_STEP: Dict[str, Dict[str, Any]] = {
    STEP_DECIMAL128: {
        "spark.rapids.sql.decimal128.enabled": True,
    },
    STEP_RELATIONAL: {
        "spark.rapids.tpu.cache.compressionCodec": "none",
    },
    STEP_ROBUSTNESS: {
        "spark.rapids.memory.gpu.allocFraction": 0.9,
        "spark.rapids.memory.gpu.maxAllocFraction": 1.0,
        "spark.rapids.tpu.memory.pool.mode": "logical",
        "spark.rapids.tpu.memory.pool.size": 0,
        "spark.rapids.tpu.memory.debug": False,
        "spark.rapids.tpu.oom.arbitration.enabled": True,
        "spark.rapids.tpu.oom.arbitration.maxWaitSeconds": 30.0,
        "spark.rapids.tpu.oom.maxRetries": 2,
        "spark.rapids.tpu.oom.maxSplits": 4,
        "spark.rapids.tpu.fallback.enabled": True,
        "spark.rapids.tpu.fallback.quarantine.enabled": True,
        "spark.rapids.tpu.fallback.quarantine.maxEntries": 256,
        "spark.rapids.tpu.fallback.quarantine.threshold": 3,
        "spark.rapids.tpu.fallback.quarantine.ttlSeconds": 86400.0,
        "spark.rapids.tpu.query.timeoutSeconds": 0.0,
        "spark.rapids.sql.concurrentGpuTasks": 1,
        "spark.rapids.tpu.donation.enabled": True,
        "spark.rapids.tpu.donation.force": False,
        "spark.rapids.tpu.faults.enabled": False,
        "spark.rapids.tpu.faults.seed": 0,
        "spark.rapids.tpu.faults.spec": "",
    },
    STEP_MULTI_GPU: {
        "spark.rapids.tpu.shuffle.mode": "auto",
        "spark.rapids.tpu.shuffle.cacheWrites": "auto",
        "spark.rapids.tpu.shuffle.exchangeChunkRows": 524288,
        "spark.rapids.tpu.shuffle.host.maxProviderRetries": 3,
        "spark.rapids.tpu.shuffle.host.storeBytes": 256 * 1024 ** 2,
        "spark.rapids.tpu.shuffle.tcp.chunkBytes": 1024 ** 2,
        "spark.rapids.tpu.shuffle.tcp.connectTimeout": 10.0,
        "spark.rapids.tpu.shuffle.tcp.readTimeout": 30.0,
        "spark.rapids.tpu.shuffle.tcp.retryAttempts": 4,
        "spark.rapids.tpu.shuffle.tcp.retryBackoffMs": 50.0,
        "spark.rapids.tpu.shuffle.tcp.retryMaxBackoffMs": 1000.0,
        "spark.rapids.shuffle.compression.codec": "none",
        "spark.rapids.shuffle.maxMetadataSize": 1024 ** 3,
        "spark.rapids.shuffle.transport.class":
            "spark_rapids_tpu.shuffle.transport.LocalShuffleTransport",
        "spark.rapids.shuffle.transport.maxReceiveInflightBytes":
            64 * 1024 ** 2,
        "spark.rapids.tpu.mesh.stageExecution.enabled": True,
        "spark.rapids.tpu.task.timeout": 300.0,
        "spark.rapids.tpu.task.maxFailures": 4,
        "spark.rapids.tpu.task.respawnWorkers": True,
        "spark.rapids.tpu.task.maxWorkerRespawns": 2,
        "spark.rapids.tpu.task.heartbeatInterval": 2.0,
        "spark.rapids.tpu.task.heartbeatTimeout": 60.0,
        "spark.rapids.tpu.pipeline.enabled": True,
        "spark.rapids.tpu.pipeline.prefetchDepth": 2,
        "spark.rapids.tpu.pipeline.taskPool": 4,
    },
    STEP_BREADTH: {  # readers and the parquet writer, float and agg
        # modes, planner, UDFs, compile cache, observability
        "spark.rapids.tpu.parquet.deviceWrite.enabled": True,
        "spark.rapids.sql.format.csv.enabled": True,
        "spark.rapids.sql.format.csv.reader.type": "AUTO",
        "spark.rapids.sql.format.json.enabled": True,
        "spark.rapids.sql.format.orc.enabled": True,
        "spark.rapids.sql.format.orc.reader.type": "AUTO",
        "spark.rapids.sql.csv.read.bool.enabled": True,
        "spark.rapids.sql.csv.read.date.enabled": True,
        "spark.rapids.sql.csv.read.double.enabled": True,
        "spark.rapids.sql.csv.read.float.enabled": True,
        "spark.rapids.sql.csv.read.int.enabled": True,
        "spark.rapids.sql.csv.read.timestamp.enabled": True,
        "spark.rapids.tpu.csv.deviceDecode.enabled": True,
        "spark.rapids.tpu.json.deviceDecode.enabled": True,
        "spark.rapids.tpu.debug.dumpPath": "",
        "spark.rapids.sql.hasNans": True,
        "spark.rapids.sql.improvedFloatOps.enabled": True,
        "spark.rapids.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.groupby.strategy": "auto",
        "spark.sql.mapKeyDedupPolicy": "exception",
        "spark.rapids.sql.mode": "executeongpu",
        "spark.rapids.sql.test.allowedNonGpu": "",
        "spark.rapids.sql.optimizer.enabled": False,
        "spark.rapids.sql.optimizer.deviceSpeedup": 4.0,
        "spark.rapids.sql.optimizer.transitionWeight": 1.0,
        "spark.rapids.tpu.sql.udfCompiler.enabled": True,
        "spark.rapids.tpu.compile.enabled": True,
        "spark.rapids.tpu.compile.cacheDir": "",
        "spark.rapids.tpu.compile.warmPool.enabled": True,
        "spark.rapids.tpu.compile.warmPool.maxSeconds": 30.0,
        "spark.rapids.tpu.compile.warmPool.maxSignatures": 32,
        "spark.rapids.tpu.shapeBuckets.growth": 2.0,
        "spark.rapids.tpu.shapeBuckets.maxWasteFrac": 0.5,
        "spark.rapids.tpu.shapeBuckets.minRows": 0,
        "spark.rapids.tpu.debug.assertions": False,
        "spark.rapids.sql.metrics.level": "MODERATE",
        "spark.rapids.tpu.metrics.kernelTableSize": 4096,
        "spark.rapids.tpu.metrics.xlaIntrospection": "lowered",
        "spark.rapids.tpu.trace.enabled": False,
        "spark.rapids.tpu.trace.dir": "",
        "spark.rapids.tpu.trace.bufferSize": 65536,
        "spark.rapids.tpu.trace.distributed.enabled": True,
        "spark.rapids.tpu.trace.distributed.dir": "",
        "spark.rapids.tpu.trace.distributed.clockProbes": 5,
        "spark.rapids.tpu.eventLog.dir": "",
        "spark.rapids.tpu.history.dir": "",
        "spark.rapids.tpu.history.baseline": "",
        "spark.rapids.tpu.health.enabled": False,
        "spark.rapids.tpu.health.intervalMs": 1000,
        "spark.rapids.tpu.health.port": -1,
        "spark.rapids.tpu.health.reportDir": "",
        "spark.rapids.tpu.health.stallTimeout": 120.0,
        "spark.rapids.tpu.movement.enabled": False,
        "spark.rapids.tpu.movement.ringSize": 4096,
        "spark.rapids.tpu.memory.profile.enabled": True,
        "spark.rapids.tpu.memory.profile.ringSize": 4096,
        "spark.rapids.tpu.shuffle.telemetry.enabled": False,
        "spark.rapids.tpu.shuffle.telemetry.ringSize": 4096,
    },
}
#: string keys the JAX package compares in lower case
_CASE_FREE = {"spark.rapids.sql.mode", "spark.sql.mapKeyDedupPolicy",
              "spark.rapids.shuffle.compression.codec"}

for _step, _keys in _UNREAD_BY_STEP.items():
    for _key, _default in _keys.items():
        register_conf(
            _key, "Read by the JAX package; the port runs its default and "
            f"raises on any other value until ROADMAP Queue 1 ({_step}) "
            "reads it.", _default,
            checker=_not_ported_unless_default(_default, _step,
                                               _key in _CASE_FREE))


class RapidsConf:
    """An immutable snapshot of config values (reference ``RapidsConf`` class)."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        settings = dict(settings or {})
        # keys no entry reads are kept raw: the per-op enable keys
        # (spark.rapids.sql.exec.* / expression.*) are derived from rule names
        self._extra = {k: v for k, v in settings.items() if k not in _REGISTRY}
        self._values: Dict[str, Any] = {
            k: entry.convert(settings.get(k)) for k, entry in _REGISTRY.items()}

    def get(self, key_or_entry) -> Any:
        key = key_or_entry.key if isinstance(key_or_entry, ConfEntry) \
            else key_or_entry
        if key in self._values:
            return self._values[key]
        return self._extra[key]

    def set(self, key: str, value: Any) -> "RapidsConf":
        merged = dict(self._values)
        merged.update(self._extra)
        merged[key] = value
        return RapidsConf(merged)

    @property
    def is_sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED)

    @property
    def explain(self) -> str:
        return self.get(SQL_EXPLAIN)

    @property
    def min_bucket_rows(self) -> int:
        return self.get(BATCH_ROWS_MIN_BUCKET)

    @property
    def batch_size_bytes(self) -> int:
        return self.get(BATCH_SIZE_BYTES)

    @property
    def shuffle_partitions(self) -> int:
        return self.get(SHUFFLE_PARTITIONS)

    @property
    def test_enabled(self) -> bool:
        return self.get(TEST_ENABLED)

    def is_op_enabled(self, conf_key: str) -> bool:
        """Per-op enable keys (spark.rapids.sql.exec.* / expression.*) default on."""
        raw = self._extra.get(conf_key)
        if raw is None:
            return True
        return str(raw).strip().lower() in ("true", "1", "yes", "on")
