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
GROUPBY_STRATEGY = register_conf(
    "spark.rapids.tpu.groupby.strategy",
    "Device group-by algorithm: 'sort' (the rows sorted by their key words, "
    "groups in key order), 'hash' (bucket-resolve rounds, groups in order "
    "of first appearance) or 'auto' (= hash).", "auto",
    checker=lambda v: None if str(v).lower() in ("auto", "sort", "hash")
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

AQE_ADVISORY_BYTES = register_conf(
    "spark.rapids.tpu.aqe.advisoryPartitionSizeBytes",
    "Target bytes per shuffle partition after AQE coalescing "
    "(spark.sql.adaptive.advisoryPartitionSizeInBytes analogue).",
    64 * 1024 * 1024)

AQE_COALESCE_ENABLED = register_conf(
    "spark.rapids.tpu.aqe.coalescePartitions.enabled",
    "Merge adjacent small shuffle partitions toward the advisory size "
    "(spark.sql.adaptive.coalescePartitions.enabled analogue).", True)

AQE_MIN_PARTITIONS = register_conf(
    "spark.rapids.tpu.aqe.coalescePartitions.minPartitionNum",
    "Lower bound on the partition count coalescing may produce.", 1)

AQE_BROADCAST_BYTES = register_conf(
    "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold",
    "Max materialized build-side bytes for AQE join demotion to broadcast; "
    "-1 disables demotion (spark.sql.adaptive + autoBroadcastJoinThreshold).",
    10 * 1024 * 1024)

AQE_SKEW_ENABLED = register_conf(
    "spark.rapids.tpu.aqe.skewJoin.enabled",
    "Split skewed probe-side partitions of shuffled hash joins "
    "(spark.sql.adaptive.skewJoin.enabled analogue).", True)

AQE_SKEW_FACTOR = register_conf(
    "spark.rapids.tpu.aqe.skewJoin.skewedPartitionFactor",
    "A partition is skewed when its bytes exceed this multiple of the "
    "median partition size (and the threshold below).", 5)

AQE_SKEW_THRESHOLD = register_conf(
    "spark.rapids.tpu.aqe.skewJoin.skewedPartitionThresholdBytes",
    "Minimum bytes for a partition to be considered skewed.",
    256 * 1024 * 1024)

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


# -- memory and robustness: the pool, the OOM ladder, host fallback, faults,
# deadlines, the task semaphore, donation and the memory profiler ----------
def _non_negative(what: str):
    def check(v):
        return None if v >= 0 else f"{what} must be >= 0, got {v}"
    return check


DEVICE_POOL_BYTES = register_conf(
    "spark.rapids.tpu.memory.pool.size",
    "Logical device budget in bytes for spillable buffers (reference: RMM "
    "pool sizing, GpuDeviceManager.scala:176-222). 0 = derive from the "
    "device.", 0)

DEVICE_POOL_MODE = register_conf(
    "spark.rapids.tpu.memory.pool.mode",
    "Buffer-pool accounting mode (reference: the RMM DEFAULT/POOL/ARENA/"
    "ASYNC selection, GpuDeviceManager.scala:224): 'logical' enforces the "
    "budget by spilling lowest-priority buffers; 'none' disables budget "
    "accounting (the caching allocator arbitrates, like RMM DEFAULT); "
    "'strict' raises when a registration cannot fit even after spilling "
    "(surface OOM early instead of overcommitting).", "logical",
    checker=lambda v: None if v in ("logical", "none", "strict")
    else f"must be one of logical/none/strict, got {v!r}")

DEVICE_POOL_FRACTION = register_conf(
    "spark.rapids.memory.gpu.allocFraction",
    "Fraction of device memory the buffer pool may use.", 0.9,
    conf_type=float)

DEVICE_POOL_MAX_FRACTION = register_conf(
    "spark.rapids.memory.gpu.maxAllocFraction",
    "Upper bound on the fraction of device memory the spillable pool may "
    "claim (reference: RapidsConf RMM_ALLOC_MAX_FRACTION).", 1.0,
    conf_type=float)

MEMORY_DEBUG = register_conf(
    "spark.rapids.tpu.memory.debug",
    "Sanitizer mode for the buffer catalog (reference: RMM debug allocator "
    "/ spark.rapids.memory.gpu.debug): double-free and release-underflow "
    "raise, freed host buffers are poisoned (0xDD), buffer creation sites "
    "are recorded, and accounting invariants are checked after every "
    "operation.", False)

OOM_MAX_RETRIES = register_conf(
    "spark.rapids.tpu.oom.maxRetries",
    "Maximum spill-and-retry attempts per retry scope before the ladder "
    "escalates to split-and-retry (or fails with a structured "
    "DeviceOomError). 0 disables plain retries.",
    2, checker=_non_negative("oom.maxRetries"))

OOM_MAX_SPLITS = register_conf(
    "spark.rapids.tpu.oom.maxSplits",
    "Maximum row-axis input halvings per retry scope for operators that "
    "declare a splitter (split-and-retry). 0 disables splitting.",
    4, checker=_non_negative("oom.maxSplits"))

OOM_ARBITRATION = register_conf(
    "spark.rapids.tpu.oom.arbitration.enabled",
    "Pause new task admissions while a thread is retrying after device OOM "
    "and serialize retriers' final attempts, giving the retrier the "
    "device's memory to itself.", True)

OOM_GATE_MAX_WAIT = register_conf(
    "spark.rapids.tpu.oom.arbitration.maxWaitSeconds",
    "Upper bound on how long a new admission parks on the OOM arbitration "
    "gate before proceeding anyway.", 30.0, conf_type=float,
    checker=lambda v: None if v > 0
    else f"maxWaitSeconds must be > 0, got {v}")

FALLBACK_ENABLED = register_conf(
    "spark.rapids.tpu.fallback.enabled",
    "Runtime host fallback: when a device operator's dispatch fails "
    "terminally (OOM ladder exhausted, or a classified non-retryable "
    "device error), download the batch, re-execute it through the host "
    "engine's implementation and re-upload.", True)

QUARANTINE_ENABLED = register_conf(
    "spark.rapids.tpu.fallback.quarantine.enabled",
    "Operator quarantine: count runtime fallbacks per (operator class, "
    "plan signature, failure class); past quarantine.threshold the "
    "planner routes that operator to the host at plan time (explain shows "
    "the reason). The store lives for the process.", True)

QUARANTINE_THRESHOLD = register_conf(
    "spark.rapids.tpu.fallback.quarantine.threshold",
    "Runtime fallbacks a (operator, plan-signature, failure-class) key "
    "must accumulate before the planner quarantines it to the host.",
    3, checker=lambda v: None if v >= 1
    else f"threshold must be >= 1, got {v}")

QUARANTINE_TTL = register_conf(
    "spark.rapids.tpu.fallback.quarantine.ttlSeconds",
    "Quarantine entry lifetime in seconds; expired entries are pruned on "
    "lookup, so a quarantined operator is tried on the device again.",
    86400.0, conf_type=float,
    checker=lambda v: None if v > 0 else f"ttlSeconds must be > 0, got {v}")

QUARANTINE_MAX_ENTRIES = register_conf(
    "spark.rapids.tpu.fallback.quarantine.maxEntries",
    "Upper bound on quarantine-store entries; the oldest entries are "
    "evicted first.", 256,
    checker=lambda v: None if v >= 1 else f"maxEntries must be >= 1, got {v}")

QUERY_TIMEOUT = register_conf(
    "spark.rapids.tpu.query.timeoutSeconds",
    "Wall-clock deadline per collect() in seconds; 0 (the default) "
    "disables it. A query past its deadline cancels cooperatively at the "
    "runtime's next yield point (retry-ladder dispatch, OOM arbitration "
    "gate) with a QueryTimeoutError carrying a forensics dump.",
    0.0, conf_type=float,
    checker=lambda v: None if v >= 0
    else f"timeoutSeconds must be >= 0, got {v}")

CONCURRENT_GPU_TASKS = register_conf(
    "spark.rapids.sql.concurrentGpuTasks",
    "Number of tasks that may submit device work concurrently per device "
    "(admission control via the task semaphore). (reference: "
    "RapidsConf.scala:412-418)", 1, checker=_positive("concurrent tasks"))

DONATION_ENABLED = register_conf(
    "spark.rapids.tpu.donation.enabled",
    "Let a fused stage drop its references to an exclusively owned input "
    "batch (an upload the scan cache does not keep) once the chain has "
    "consumed it, so the caching allocator can reuse those planes for the "
    "output. Cached and spillable batches are never donated. Off on the "
    "CPU unless donation.force.", True)

DONATION_FORCE = register_conf(
    "spark.rapids.tpu.donation.force",
    "Testing only: donate on the CPU too.", False)

FAULTS_ENABLED = register_conf(
    "spark.rapids.tpu.faults.enabled",
    "Enable the fault-injection framework. When false (the default) every "
    "fault point is a single module-constant check and nothing is ever "
    "injected.", False)

FAULTS_SPEC = register_conf(
    "spark.rapids.tpu.faults.spec",
    "Fault-injection spec: semicolon-separated clauses of the form "
    "point[:key=value]* with keys p|prob (fire probability), times (max "
    "fires), after (skip first N evaluations), latency_ms and action "
    "(raise|kill|corrupt|delay|oom|fatal).", "")

FAULTS_SEED = register_conf(
    "spark.rapids.tpu.faults.seed",
    "Seed for the per-point deterministic RNG streams used by "
    "probabilistic fault clauses.", 0)

MEMPROF_ENABLED = register_conf(
    "spark.rapids.tpu.memory.profile.enabled",
    "Record buffer-catalog allocation lifecycle events (register/spill/"
    "restore/free with byte deltas and the owning query and operator) into "
    "the process-wide memory flight recorder: per-operator live and peak "
    "device bytes, leak detection at query end, and OOM postmortems.",
    True)

MEMPROF_RING_SIZE = register_conf(
    "spark.rapids.tpu.memory.profile.ringSize",
    "Ring-buffer capacity of the memory flight recorder in lifecycle "
    "events; overflow drops the oldest events.", 4096,
    checker=lambda v: None if v > 0 else f"must be positive, got {v}")


DECIMAL128_ENABLED = register_conf(
    "spark.rapids.sql.decimal128.enabled",
    "Run DECIMAL(19..38) on the device as two-limb int64 columns "
    "(add/sub/mul, comparisons, sum/count aggregates, sort, group-by and "
    "join keys, casts). When off, wide decimals fall back to the host "
    "engine's exact object-int path (reference: the DECIMAL_128 TypeSig "
    "tier, TypeChecks.scala:465).", True)


# -- the multi-GPU tier: exchanges across a mesh, mesh stages, the pipeline
# and the in-process executor tier --------------------------------------
def _one_of(*values):
    def check(v):
        return None if v in values \
            else f"must be one of {'/'.join(values)}, got {v!r}"
    return check


def _codec_check(*values):
    """One of ``values`` in any case, stored in lower case (the JAX
    package's shuffle codec check)."""
    def check(v):
        return _one_of(*values)(v.lower())
    check.normalize = str.lower
    return check


SHUFFLE_MODE = register_conf(
    "spark.rapids.tpu.shuffle.mode",
    "Shuffle exchange tier: 'auto' exchanges across the device mesh when "
    "the session has a mesh of two or more shards attached, and coalesces "
    "into one device partition when it does not; 'ici' builds a mesh over "
    "every visible card; 'local' forces the one-partition device tier; "
    "'host' forces the host-staged tier.", "auto",
    checker=_one_of("auto", "host", "ici", "local"))

EXCHANGE_CHUNK_ROWS = register_conf(
    "spark.rapids.tpu.shuffle.exchangeChunkRows",
    "Max staged row capacity per device-exchange chunk: child batches "
    "stream through the mesh exchange in chunks of this many rows, so only "
    "one chunk is staged at a time and finished output shards can spill.",
    1 << 19, checker=_positive("exchange chunk rows"))

MESH_STAGE_ENABLED = register_conf(
    "spark.rapids.tpu.mesh.stageExecution.enabled",
    "Run the fusible operators after a mesh exchange (project, filter, "
    "partial aggregate, and a final aggregate when the exchange streamed "
    "one chunk) over every shard at once, on the exchange's output still "
    "sharded, with no host read between shards.", True)

SHUFFLE_CACHE_WRITES = register_conf(
    "spark.rapids.tpu.shuffle.cacheWrites",
    "Cache written shuffle partitions in the device store as spillable "
    "buffers (reference: RapidsCachingWriter + ShuffleBufferCatalog): same-"
    "process readers consume them with no serialize/upload round trip. "
    "'auto' enables it for the in-process transport only; 'on'/'off' force.",
    "auto", checker=_one_of("auto", "on", "off"))

SHUFFLE_COMPRESSION_CODEC = register_conf(
    "spark.rapids.shuffle.compression.codec",
    "Codec for shuffle payloads: lz4 (the host native library's LZ4 block "
    "codec, reference nvcomp LZ4), zlib, or none; zstd, which the serializer "
    "does not have, takes lz4, as in the JAX package.", "none",
    checker=_codec_check("none", "zlib", "zstd", "lz4"))

MAX_METADATA_SIZE = register_conf(
    "spark.rapids.shuffle.maxMetadataSize",
    "Throttle: the most fetched shuffle bytes a reader holds on the host "
    "before it uploads them as one device batch (reference: "
    "maxReceiveInflightBytes, RapidsConf.scala:1064).", 1024 * 1024 * 1024,
    checker=_positive("max metadata size"))

SHUFFLE_TRANSPORT_CLASS = register_conf(
    "spark.rapids.shuffle.transport.class",
    "Fully-qualified class name of the shuffle transport, loaded by name "
    "(reference: RapidsShuffleTransport.scala:545). A class of the JAX "
    "package names the port's class of the same name.",
    "spark_rapids_tpu.shuffle.transport.LocalShuffleTransport")

CACHE_COMPRESS_CODEC = register_conf(
    "spark.rapids.tpu.cache.compressionCodec",
    "Codec for the host-side df.cache() storage: 'none' keeps live tables, "
    "'zlib'/'lz4' store compressed serialized frames. The device cache is "
    "spillable either way.", "none",
    checker=_one_of("none", "zlib", "lz4"))

PIPELINE_ENABLED = register_conf(
    "spark.rapids.tpu.pipeline.enabled",
    "Drain the partitions of a collect concurrently from a bounded task "
    "pool under task-semaphore admission, and hand batches across the "
    "exchange's map side through a bounded prefetch queue; 'false' "
    "restores strictly sequential execution.", True)

PIPELINE_PREFETCH_DEPTH = register_conf(
    "spark.rapids.tpu.pipeline.prefetchDepth",
    "Bound of each prefetch queue, in batches.", 2,
    checker=_positive("prefetch depth"))

PIPELINE_TASK_POOL = register_conf(
    "spark.rapids.tpu.pipeline.taskPool",
    "Most partitions a pipelined collect drains at once (each holds the "
    "task semaphore for its drain).", 4, checker=_positive("task pool"))


# -- the multi-GPU tier across processes: the TCP transport, ProcessCluster
# and the shuffle observatory ------------------------------------------------
TCP_CHUNK_BYTES = register_conf(
    "spark.rapids.tpu.shuffle.tcp.chunkBytes",
    "Window size for serving shuffle blocks over the TCP transport: a "
    "block streams in fixed-size chunks instead of one send (reference: "
    "BufferSendState bounce-buffer windows, RapidsShuffleServer.scala:70).",
    1 << 20, checker=_positive("chunk bytes"))

MAX_RECEIVE_INFLIGHT = register_conf(
    "spark.rapids.shuffle.transport.maxReceiveInflightBytes",
    "Receive-side throttle: total bytes of shuffle blocks in flight "
    "(being fetched or fetched-but-unconsumed) at one time (reference: "
    "RapidsConf.scala:1064).", 64 << 20,
    checker=_positive("max receive inflight bytes"))

HOST_STORE_BYTES = register_conf(
    "spark.rapids.tpu.shuffle.host.storeBytes",
    "In-memory budget for published shuffle blocks on the TCP transport; "
    "overflow spills oldest-first to local disk and is served from there.",
    256 << 20, checker=_positive("host store bytes"))

TCP_CONNECT_TIMEOUT = register_conf(
    "spark.rapids.tpu.shuffle.tcp.connectTimeout",
    "Seconds to wait for a TCP connect to a shuffle peer before the "
    "attempt counts as a transient failure (retried with backoff).",
    10.0, checker=_positive("connect timeout"))

TCP_READ_TIMEOUT = register_conf(
    "spark.rapids.tpu.shuffle.tcp.readTimeout",
    "Per-socket-operation read timeout (seconds) on shuffle connections, "
    "client and server side.", 30.0, checker=_positive("read timeout"))

TCP_RETRY_ATTEMPTS = register_conf(
    "spark.rapids.tpu.shuffle.tcp.retryAttempts",
    "Attempts per peer for one ranged shuffle request. Transient socket "
    "errors are retried with exponential backoff and jitter; a peer "
    "answering 'block not found' is definitive and never retried.",
    4, checker=_positive("retry attempts"))

TCP_RETRY_BACKOFF_MS = register_conf(
    "spark.rapids.tpu.shuffle.tcp.retryBackoffMs",
    "Base backoff (milliseconds) between transient-error retries; grows "
    "exponentially per attempt with +/-50% jitter.",
    50.0, checker=_positive("retry backoff"))

TCP_RETRY_MAX_BACKOFF_MS = register_conf(
    "spark.rapids.tpu.shuffle.tcp.retryMaxBackoffMs",
    "Cap (milliseconds) on the exponential retry backoff.",
    1000.0, checker=_positive("max backoff"))

TCP_MAX_PROVIDER_RETRIES = register_conf(
    "spark.rapids.tpu.shuffle.host.maxProviderRetries",
    "Times a lazy block provider that raised may be re-registered for "
    "another request before the block reports missing.",
    3, checker=_positive("provider retries"))

TASK_TIMEOUT = register_conf(
    "spark.rapids.tpu.task.timeout",
    "Default seconds a ProcessCluster task may run before the driver gives "
    "up and raises TaskTimeoutError with worker forensics (last heartbeat "
    "age, pending-queue depth). Per-call override via run_on(timeout_s=...).",
    300.0, checker=_positive("task timeout"))

TASK_MAX_FAILURES = register_conf(
    "spark.rapids.tpu.task.maxFailures",
    "Times a task may be attempted across worker deaths before the driver "
    "fails it with TaskFailedError (tasks are re-attempted only on worker "
    "loss, never on application errors, which fail fast).",
    4, checker=_positive("max failures"))

TASK_RESPAWN_WORKERS = register_conf(
    "spark.rapids.tpu.task.respawnWorkers",
    "Replace a worker process that died on its own (crash, injected kill, "
    "heartbeat wedge) with a fresh one on the same slot. Deliberate "
    "ProcessCluster.kill() always excludes the slot instead.", True)

TASK_MAX_WORKER_RESPAWNS = register_conf(
    "spark.rapids.tpu.task.maxWorkerRespawns",
    "Respawns allowed per worker slot before the slot is excluded from "
    "the cluster.", 2)

TASK_HEARTBEAT_INTERVAL = register_conf(
    "spark.rapids.tpu.task.heartbeatInterval",
    "Seconds between worker heartbeat records on the result queue.",
    2.0, checker=_positive("heartbeat interval"))

TASK_HEARTBEAT_TIMEOUT = register_conf(
    "spark.rapids.tpu.task.heartbeatTimeout",
    "Seconds of heartbeat silence (measured only while the driver is "
    "waiting on a task) before a live worker process is declared wedged, "
    "recycled, and its tasks resubmitted.",
    60.0, checker=_positive("heartbeat timeout"))

SHUFFLE_TELEMETRY_ENABLED = register_conf(
    "spark.rapids.tpu.shuffle.telemetry.enabled",
    "Enable the shuffle observatory (shuffle/telemetry.py): every transfer "
    "on every shuffle tier (ici/local/cached/transport/dcn) is recorded "
    "with phase walls, logical and wire bytes, retries and publish-queue "
    "depth. When false (the default) every hook is one module-constant "
    "check and nothing is recorded.", False)

SHUFFLE_TELEMETRY_RING_SIZE = register_conf(
    "spark.rapids.tpu.shuffle.telemetry.ringSize",
    "Bounded capacity of the shuffle observatory's raw-event ring. Oldest "
    "events drop first; the per-(query, shuffle, tier) aggregation is exact "
    "regardless.", 4096, checker=_positive("ring size"))


#: Every key the JAX package registers that this engine does not read yet,
#: with the JAX default, by the ROADMAP Queue 1 step that will read it. The
#: port keeps its own copy (it imports nothing of the JAX package);
#: tests/test_torch_conf.py holds it equal to the JAX registry.
_UNREAD_BY_STEP: Dict[str, Dict[str, Any]] = {
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
    },
}
#: string keys the JAX package compares in lower case
_CASE_FREE = {"spark.rapids.sql.mode", "spark.sql.mapKeyDedupPolicy"}

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
