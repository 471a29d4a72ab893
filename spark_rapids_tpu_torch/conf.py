"""Typed configuration — the port's copy of ``spark_rapids_tpu/conf.py``
with only the keys this engine reads.

A typed registry of ``spark.rapids.*`` entries with docs, defaults and
validators (reference: ``RapidsConf.scala``, builder DSL at lines 121-299).
Keys keep the JAX package's names so a configuration carries over.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = ["ConfEntry", "RapidsConf", "register_conf"]

_REGISTRY: "Dict[str, ConfEntry]" = {}


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
            err = self.checker(v)
            if err:
                raise ValueError(f"{self.key}: {err}")
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
    "Target device batch size in bytes: a sort whose input batches exceed "
    "it together raises until the out-of-core sort is ported (ROADMAP "
    "Queue 1 step 9). "
    "(reference: RapidsConf.scala:425-432)",
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
