"""The override pass: rule registry + main pass — the port of
``spark_rapids_tpu/plan/overrides.py`` cut to the rules for this engine's
nodes and expressions (reference: GpuOverrides.scala:4008 apply; rule
tables at :3348-3800).

``apply_overrides(cpu_plan, conf, device)`` wraps the plan in metas, tags
every node and expression with device capability (recording the reasons when
it cannot run), converts convertible subtrees to device execs on ``device``,
inserts host<->device transitions, and runs whole-stage fusion. Nodes and
expressions without a rule here are not ported yet: ``explain`` says so and
they run on the host engine.
"""
from __future__ import annotations

import torch

from ..columnar.dtypes import TypeEnum, TypeSig
from ..conf import JOIN_STRATEGY, PARQUET_DEVICE_DECODE, RapidsConf
from ..exec.aggregate import TpuHashAggregateExec
from ..exec.basic import TpuFilterExec, TpuLocalLimitExec, TpuProjectExec
from ..exec.exchange import TpuLocalExchangeExec
from ..exec.joins import (TpuBroadcastHashJoinExec, TpuShuffledHashJoinExec,
                          join_unsupported_reason)
from ..exec.scan import TpuParquetScanExec
from ..exec.sort import TpuSortExec, TpuTakeOrderedExec
from ..exec.wholestage import fuse_stages
from ..expr import aggregates as A
from ..expr import arithmetic as AR
from ..expr import conditional as C
from ..expr import datetimes as D
from ..expr import predicates as P
from ..expr import strings as S
from ..expr.base import Alias, AttributeReference, Literal
from ..expr.cast import Cast, cast_supported
from ..io.parquet import ParquetSource
from ..udf.columnar import ColumnarUDF
from .meta import register_exec_rule, register_expr_rule, wrap_plan
from .physical import (CpuCollectLimitExec, CpuFilterExec,
                       CpuGlobalLimitExec, CpuHashAggregateExec,
                       CpuLocalLimitExec, CpuProjectExec, CpuScanExec,
                       CpuSortExec, CpuTakeOrderedExec, PhysicalPlan,
                       ShuffleExchangeExec)
from .physical_joins import CpuBroadcastHashJoinExec, CpuShuffledHashJoinExec
from .transitions import insert_transitions

__all__ = ["apply_overrides", "explain_plan"]

#: the fixed-width types of the device batch layout
_device_common = TypeSig.numeric + TypeSig.of(
    TypeEnum.BOOLEAN, TypeEnum.DATE, TypeEnum.TIMESTAMP, TypeEnum.NULL)
#: plus strings, as the byte matrix: columns that operators carry, group
#: by, sort by and compare
_device_all = _device_common + TypeSig.of(TypeEnum.STRING)
#: the JAX package's signature of its string functions
_string = TypeSig.of(TypeEnum.STRING, TypeEnum.BINARY, TypeEnum.INT,
                     TypeEnum.BOOLEAN)
#: ... and of its date parts
_dt_sig = TypeSig.of(TypeEnum.DATE, TypeEnum.TIMESTAMP, TypeEnum.INT,
                     TypeEnum.LONG, TypeEnum.DOUBLE) + TypeSig.integral


def _register_expr_rules():
    for cls in (AttributeReference, Alias, Literal,
                P.EqualTo, P.GreaterThan, P.GreaterThanOrEqual, P.LessThan,
                P.LessThanOrEqual, P.In):
        register_expr_rule(cls, _device_all)
    for cls in (AR.Add, AR.Subtract, AR.Multiply, AR.Divide,
                AR.IntegralDivide, AR.Remainder, AR.Pmod, AR.UnaryMinus,
                AR.Abs,
                P.EqualNullSafe, P.And, P.Or, P.Not,
                P.IsNull, P.IsNotNull, P.IsNaN,
                C.If, C.CaseWhen, C.Coalesce,
                A.Sum, A.Min, A.Max, A.Count, A.CountStar, A.Average):
        register_expr_rule(cls, _device_common)

    def tag_cast(meta, conf):
        c: Cast = meta.expr
        if not cast_supported(c.child.data_type, c.to):
            meta.cannot_run(f"cast {c.child.data_type!r} -> {c.to!r} is not "
                            "ported yet")
    register_expr_rule(Cast, _device_common, tag_fn=tag_cast)

    def tag_columnar_udf(meta, conf):
        if not meta.expr.device_ok:
            meta.cannot_run(f"columnar UDF {meta.expr.udf_name!r} declared "
                            "device_ok=False")
    register_expr_rule(ColumnarUDF, _device_common, tag_fn=tag_columnar_udf)
    _register_string_rules()
    for cls in (D.Year, D.Month, D.DayOfMonth, D.DayOfWeek, D.WeekDay,
                D.DayOfYear, D.WeekOfYear, D.Quarter):
        register_expr_rule(cls, _dt_sig)


def _register_string_rules():
    """The JAX package's rules (``plan/overrides.py`` string rules) for the
    string functions ported here, with its tags and reasons."""
    register_expr_rule(S.Substring, _string + TypeSig.integral)
    register_expr_rule(S.StartsWith, _string)
    register_expr_rule(S.EndsWith, _string)

    def tag_contains(meta, conf):
        if S.literal_value(meta.expr.right) is None:
            meta.cannot_run("device contains pattern requires a literal")
    register_expr_rule(S.Contains, _string, tag_fn=tag_contains)

    def tag_like(meta, conf):
        e: S.Like = meta.expr
        if S.literal_value(e.pattern) is None:
            meta.cannot_run("device LIKE requires a literal pattern")
            return
        if e.simple_kind() is None and e.device_nfa() is None:
            meta.cannot_run("LIKE pattern outside the device regex subset")
    register_expr_rule(S.Like, _string, tag_fn=tag_like)


def _register_exec_rules():
    register_exec_rule(
        CpuProjectExec, _device_all,
        lambda p, ch, conf, device: TpuProjectExec(ch[0], p.exprs, p.names),
        exprs_fn=lambda p: p.exprs)
    register_exec_rule(
        CpuFilterExec, _device_all,
        lambda p, ch, conf, device: TpuFilterExec(ch[0], p.condition),
        exprs_fn=lambda p: [p.condition])

    def tag_agg(meta, conf):
        # string keys group by their packed byte words; aggregate inputs
        # and states stay fixed-width (string min/max is not ported)
        p: CpuHashAggregateExec = meta.plan
        in_schema = p.child.schema
        for s in p.specs:
            in_cols = s.input_cols if p.mode == "partial" \
                else [n for (n, _, _) in s.state_fields]
            for c in in_cols:
                for r in _device_common.reasons_not_supported(
                        in_schema.field(c).dtype):
                    meta.cannot_run(f"aggregate input {c}: {r}")
            for (n, d, _) in s.state_fields:
                for r in _device_common.reasons_not_supported(d):
                    meta.cannot_run(f"aggregate state {n}: {r}")

    register_exec_rule(
        CpuHashAggregateExec, _device_all,
        lambda p, ch, conf, device: TpuHashAggregateExec(
            ch[0], p.key_names, p.specs, p.mode, device,
            conf.min_bucket_rows),
        tag_fn=tag_agg)
    register_exec_rule(
        CpuSortExec, _device_all,
        lambda p, ch, conf, device: TpuSortExec(
            ch[0], p.orders, conf.min_bucket_rows, conf.batch_size_bytes,
            conf),
        exprs_fn=lambda p: [o.expr for o in p.orders])
    register_exec_rule(
        CpuTakeOrderedExec, _device_all,
        lambda p, ch, conf, device: TpuTakeOrderedExec(
            ch[0], p.orders, p.n, conf.min_bucket_rows),
        exprs_fn=lambda p: [o.expr for o in p.orders])
    # a global or collect limit sits above a single-partition child, where
    # the local limit's semantics are exactly right (limit.scala)
    for cls in (CpuLocalLimitExec, CpuGlobalLimitExec, CpuCollectLimitExec):
        register_exec_rule(
            cls, _device_all,
            lambda p, ch, conf, device: TpuLocalLimitExec(ch[0], p.n))

    def tag_join(meta, conf):
        p = meta.plan
        reason = join_unsupported_reason(p.how, p.left_keys, p.right_keys,
                                         p.left.schema, p.right.schema)
        if reason is not None:
            meta.cannot_run(reason)

    for cpu_cls, tpu_cls in ((CpuShuffledHashJoinExec,
                              TpuShuffledHashJoinExec),
                             (CpuBroadcastHashJoinExec,
                              TpuBroadcastHashJoinExec)):
        register_exec_rule(
            cpu_cls, _device_all,
            lambda p, ch, conf, device, tpu_cls=tpu_cls: tpu_cls(
                ch[0], ch[1], p.left_keys, p.right_keys, p.how, p.condition,
                p.merge_keys, device, str(conf.get(JOIN_STRATEGY)).lower(),
                conf.min_bucket_rows, conf.batch_size_bytes, conf),
            exprs_fn=lambda p: [] if p.condition is None else [p.condition],
            tag_fn=tag_join)

    def tag_scan(meta, conf):
        # a parquet scan decodes on the device (exec/scan.py); other
        # sources and a scan with a pushed filter stay on the host reader
        p: CpuScanExec = meta.plan
        if not isinstance(p.source, ParquetSource):
            meta.cannot_run(f"{p.source.name()} decodes host-side (parquet "
                            "has a device decoder)")
            return
        if not conf.get(PARQUET_DEVICE_DECODE):
            meta.cannot_run("device parquet decode disabled by "
                            "spark.rapids.tpu.parquet.deviceDecode.enabled")
            return
        if p.source.filter_expr is not None:
            meta.cannot_run("pushed filter uses the host reader's "
                            "row-group statistics pruning")

    register_exec_rule(
        CpuScanExec, _device_all,
        lambda p, ch, conf, device: TpuParquetScanExec(
            p.source, p.columns, p.schema, conf.min_bucket_rows, device),
        tag_fn=tag_scan)
    # one device holds the whole exchange output (exec/exchange.py)
    register_exec_rule(
        ShuffleExchangeExec, _device_all,
        lambda p, ch, conf, device: TpuLocalExchangeExec(
            ch[0], p.partitioning, conf.min_bucket_rows))


_register_expr_rules()
_register_exec_rules()


def explain_plan(cpu_plan: PhysicalPlan, conf: RapidsConf) -> str:
    meta = wrap_plan(cpu_plan)
    meta.tag(conf)
    return meta.explain(not_on_device_only=(conf.explain == "NOT_ON_GPU"))


def apply_overrides(cpu_plan: PhysicalPlan, conf: RapidsConf,
                    device: torch.device) -> PhysicalPlan:
    """Tag + convert + insert transitions + fuse (SURVEY §3.2 call stack)."""
    meta = wrap_plan(cpu_plan)
    meta.tag(conf)
    if conf.explain != "NONE":
        text = meta.explain(not_on_device_only=(conf.explain == "NOT_ON_GPU"))
        if text:
            print(text)
    if conf.test_enabled:
        for m in meta.walk():
            # a scan that cannot decode on the device reads on the host
            if not m.can_run and not isinstance(m.plan, CpuScanExec):
                raise AssertionError(
                    f"[test.enabled] {type(m.plan).__name__} fell off the "
                    f"device: {m.reasons}")
    converted = meta.convert_if_needed(conf, device)
    return fuse_stages(insert_transitions(converted, conf, device))
