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

Decimals pass every numeric signature up to 18 digits; the rules of the
ops whose device code takes two-limb columns raise the gate to 38 (the
JAX package's DECIMAL_128 section) and, with
``spark.rapids.sql.decimal128.enabled`` off, send every node and
expression that touches a wide decimal to the host engine.
"""
from __future__ import annotations

import torch

from ..columnar.dtypes import TypeEnum, TypeSig
from ..columnar import dtypes as dt
from ..conf import (DECIMAL128_ENABLED, EXCHANGE_CHUNK_ROWS,
                    GROUPBY_STRATEGY, JOIN_STRATEGY, PARQUET_DEVICE_DECODE,
                    SHUFFLE_MODE, RapidsConf)
from ..exec.aggregate import TpuHashAggregateExec
from ..exec.basic import (TpuExpandExec, TpuFilterExec, TpuLocalLimitExec,
                          TpuProjectExec, TpuRangeExec, TpuSampleExec,
                          TpuUnionExec)
from ..exec.cache import CpuCacheExec, TpuCacheExec
from ..exec.exchange import TpuLocalExchangeExec, TpuShuffleExchangeExec
from ..exec.fallback import plan_quarantine_pass
from ..exec.joins import (TpuBroadcastHashJoinExec,
                          TpuBroadcastNestedLoopJoinExec,
                          TpuShuffledHashJoinExec, join_unsupported_reason)
from ..exec.scan import TpuParquetScanExec
from ..exec.sort import TpuSortExec, TpuTakeOrderedExec
from ..exec.wholestage import donation_active, fuse_stages
from ..exec.window import TpuWindowExec
from ..expr import aggregates as A
from ..expr import arithmetic as AR
from ..expr import conditional as C
from ..expr import datetimes as D
from ..expr import hashing as H
from ..expr import math as MA
from ..expr import predicates as P
from ..expr import strings as S
from ..expr.base import Alias, AttributeReference, Literal
from ..expr.cast import Cast, device_cast_reason
from ..io.parquet import ParquetSource
from ..udf.columnar import ColumnarUDF
from .meta import register_exec_rule, register_expr_rule, wrap_plan
from ..expr import window as W
from .physical import (CpuCollectLimitExec, CpuExpandExec, CpuFilterExec,
                       CpuGlobalLimitExec, CpuHashAggregateExec,
                       CpuLocalLimitExec, CpuProjectExec, CpuRangeExec,
                       CpuSampleExec, CpuScanExec, CpuSortExec,
                       CpuTakeOrderedExec, CpuUnionExec, HashPartitioning,
                       PhysicalPlan, ShuffleExchangeExec)
from .physical_joins import (CpuBroadcastHashJoinExec,
                             CpuBroadcastNestedLoopJoinExec,
                             CpuShuffledHashJoinExec)
from .physical_window import CpuWindowExec
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
                A.Sum, A.Min, A.Max, A.Count, A.CountStar, A.Average,
                A.First, A.Last, A.StddevPop, A.StddevSamp, A.VariancePop,
                A.VarianceSamp, A.ApproximatePercentile, MA.Ceil, MA.Floor,
                MA.Round):
        register_expr_rule(cls, _device_common)

    def tag_cast(meta, conf):
        """The JAX package's ``tag_cast``: string casts run on the kernels
        of expr/cast_kernels.py; the directions without one fall back."""
        c: Cast = meta.expr
        reason = device_cast_reason(c.child.data_type, c.to)
        if reason is not None:
            meta.cannot_run(reason)
    register_expr_rule(Cast, _device_all, tag_fn=tag_cast)
    # the JAX package's math rules (overrides.py:74-78, :238-242)
    for cls in (MA.Acos, MA.Asin, MA.Atan, MA.Cbrt, MA.Cos, MA.Cosh, MA.Exp,
                MA.Expm1, MA.Log, MA.Log10, MA.Log1p, MA.Log2, MA.Rint,
                MA.Signum, MA.Sin, MA.Sinh, MA.Sqrt, MA.Tan, MA.Tanh,
                MA.ToDegrees, MA.ToRadians, MA.Pow, MA.Atan2):
        register_expr_rule(cls, TypeSig.fp + TypeSig.integral)
    # ... its bitwise rules (:447-455): shifts take INT and LONG values
    register_expr_rule(AR.BitwiseNot, TypeSig.integral)
    for cls in (AR.ShiftLeft, AR.ShiftRight, AR.ShiftRightUnsigned):
        register_expr_rule(cls, TypeSig.of(TypeEnum.INT, TypeEnum.LONG))
    # ... its hash and id rules (:435-446, _register_misc_rules)
    register_expr_rule(H.Murmur3Hash, _device_all)
    register_expr_rule(H.XxHash64, _device_all)
    register_expr_rule(H.SparkPartitionID, _device_all)
    register_expr_rule(H.MonotonicallyIncreasingID, _device_all)

    def tag_columnar_udf(meta, conf):
        if not meta.expr.device_ok:
            meta.cannot_run(f"columnar UDF {meta.expr.udf_name!r} declared "
                            "device_ok=False")
    register_expr_rule(ColumnarUDF, _device_common, tag_fn=tag_columnar_udf)
    _register_string_rules()
    # ... and its datetime rules (:420-432)
    for cls in (D.Year, D.Month, D.DayOfMonth, D.DayOfWeek, D.WeekDay,
                D.DayOfYear, D.WeekOfYear, D.Quarter, D.Hour, D.Minute,
                D.Second, D.DateAdd, D.DateSub, D.DateDiff, D.AddMonths,
                D.LastDay, D.MonthsBetween, D.TimeAdd, D.UnixTimestamp,
                D.TruncDate):
        register_expr_rule(cls, _dt_sig)

    def host_only_format(meta, conf):
        meta.cannot_run("host-only: formatting")
    for cls in (D.FromUnixTime, D.DateFormatClass):
        register_expr_rule(cls, _dt_sig + TypeSig.of(TypeEnum.STRING),
                           tag_fn=host_only_format)


def _register_string_rules():
    """The JAX package's string rules (``plan/overrides.py``
    ``_register_string_rules``), with its tags and reasons, and its
    host-only rule for get_json_object."""
    ascii_note = ("device case mapping is ASCII-only (host fallback is "
                  "Unicode)")
    register_expr_rule(S.Upper, _string.with_ps_note(TypeEnum.STRING,
                                                     ascii_note))
    register_expr_rule(S.Lower, _string.with_ps_note(TypeEnum.STRING,
                                                     ascii_note))
    register_expr_rule(S.InitCap, _string.with_ps_note(TypeEnum.STRING,
                                                       ascii_note))
    for cls in (S.Length, S.OctetLength, S.BitLength, S.StringReverse,
                S.Ascii, S.StartsWith, S.EndsWith, S.Concat, S.StringTrim,
                S.StringTrimLeft, S.StringTrimRight):
        register_expr_rule(cls, _string)
    register_expr_rule(S.Substring, _string + TypeSig.integral)

    def _require_lit(child_attr, what):
        def tag(meta, conf):
            if S.literal_value(getattr(meta.expr, child_attr)) is None:
                meta.cannot_run(f"device {what} requires a literal")
        return tag

    register_expr_rule(S.Contains, _string,
                       tag_fn=_require_lit("right", "contains pattern"))
    register_expr_rule(S.StringLocate, _string + TypeSig.integral,
                       tag_fn=_require_lit("substr", "locate pattern"))

    def tag_pad(meta, conf):
        e = meta.expr
        if S.literal_value(e.length) is None \
                or S.literal_value(e.pad) is None:
            meta.cannot_run("device pad requires literal length/pad")
    pad_note = "device pads count bytes (ASCII-exact; the host counts " \
        "characters)"
    for cls in (S.StringLpad, S.StringRpad):
        register_expr_rule(cls, (_string + TypeSig.integral).with_ps_note(
            TypeEnum.STRING, pad_note), tag_fn=tag_pad)

    def tag_repeat(meta, conf):
        if S.literal_value(meta.expr.times) is None:
            meta.cannot_run("device repeat requires literal count")
    register_expr_rule(S.StringRepeat, _string + TypeSig.integral,
                       tag_fn=tag_repeat)

    def tag_like(meta, conf):
        e: S.Like = meta.expr
        if S.literal_value(e.pattern) is None:
            meta.cannot_run("device LIKE requires a literal pattern")
            return
        if e.simple_kind() is None and e.device_nfa() is None:
            meta.cannot_run("LIKE pattern outside the device regex subset")
    register_expr_rule(S.Like, _string, tag_fn=tag_like)

    def tag_rlike(meta, conf):
        e: S.RLike = meta.expr
        pat = S.literal_value(e.pattern)
        if pat is None:
            meta.cannot_run("device rlike requires a literal pattern")
            return
        if e.device_nfa() is None:
            meta.cannot_run(
                f"regex {pat!r} outside the device NFA subset (transpiler "
                "rejected it; runs on host)")
    register_expr_rule(S.RLike, _string, tag_fn=tag_rlike)

    def tag_replace(meta, conf):
        e: S.StringReplace = meta.expr
        if S.literal_value(e.search) is None \
                or S.literal_value(e.replace) is None:
            meta.cannot_run("device replace requires literal "
                            "search/replacement")
            return
        if any(ord(ch) > 127 for ch in S.literal_value(e.search)):
            meta.cannot_run("non-ASCII search runs on host (byte-span "
                            "alignment)")
    register_expr_rule(S.StringReplace, _string, tag_fn=tag_replace)

    def _span_nfa(meta, pattern):
        if pattern is None:
            meta.cannot_run("device regex requires a literal pattern")
            return None
        from ..expr.regex import compile_device_nfa
        nfa = compile_device_nfa(pattern)
        if nfa is None:
            meta.cannot_run(f"regex {pattern!r} outside the device NFA "
                            "subset")
            return None
        if not nfa.spans_supported:
            meta.cannot_run(
                f"regex {pattern!r} matches but spans are host-only "
                "(alternation/lazy/nullable/non-ASCII patterns)")
            return None
        return nfa

    def tag_regexp_replace(meta, conf):
        import re
        e: S.RegExpReplace = meta.expr
        pat = S.literal_value(e.pattern)
        if _span_nfa(meta, pat) is None:
            return
        repl = S.literal_value(e.replacement)
        if repl is None:
            meta.cannot_run("null replacement runs on host")
            return
        if re.search(r"\$\d", repl):
            # $n group refs run on the device over the deterministic
            # group-plan subset (reference: GpuRegExpReplace group refs,
            # stringFunctions.scala:895 + RegexParser.scala:414)
            from ..expr.regex import (compile_group_plan,
                                      parse_replacement_template)
            plan = compile_group_plan(pat)
            if plan is None:
                meta.cannot_run(
                    f"regexp_replace: pattern {pat!r} outside the device "
                    "capture-group subset (non-deterministic greedy walk)")
                return
            if parse_replacement_template(repl, plan.ngroups) is None:
                meta.cannot_run(
                    f"replacement {repl!r} is not a valid Java group-ref "
                    "template for this pattern")
    register_expr_rule(S.RegExpReplace, _string, tag_fn=tag_regexp_replace)

    def tag_regexp_extract(meta, conf):
        e: S.RegExpExtract = meta.expr
        pat = S.literal_value(e.pattern)
        if _span_nfa(meta, pat) is None:
            return
        idx = S.literal_value(e.idx)
        if idx is None:
            meta.cannot_run("device regexp_extract requires a literal "
                            "group index")
            return
        if int(idx) != 0:
            # capture groups run on the device when the pattern linearizes
            # into the deterministic group plan (the reference transpiles
            # capture groups the same way, RegexParser.scala:414)
            from ..expr.regex import compile_group_plan
            plan = compile_group_plan(pat)
            if plan is None:
                meta.cannot_run(
                    f"regexp_extract: pattern {pat!r} outside the device "
                    "capture-group subset (non-deterministic greedy walk)")
            elif int(idx) > plan.ngroups:
                meta.cannot_run(f"group index {idx} > group count "
                                f"{plan.ngroups}")
    register_expr_rule(S.RegExpExtract, _string, tag_fn=tag_regexp_extract)

    def tag_substring_index(meta, conf):
        e = meta.expr
        if S.literal_value(e.delim) is None \
                or S.literal_value(e.count) is None:
            meta.cannot_run("device substring_index requires literal "
                            "delimiter/count")
    register_expr_rule(S.SubstringIndex, _string + TypeSig.integral,
                       tag_fn=tag_substring_index)
    register_expr_rule(S.ConcatWs, _string)
    register_expr_rule(S.Chr, TypeSig.of(TypeEnum.STRING, TypeEnum.INT,
                                         TypeEnum.LONG))

    def host_only_json(meta, conf):
        meta.cannot_run("host-only: JSON parsing")
    register_expr_rule(S.GetJsonObject, _string, tag_fn=host_only_json)


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
        # and states stay fixed-width (string min/max is not ported), wide
        # decimals included (their ops are gated by the decimal128 rules)
        p: CpuHashAggregateExec = meta.plan
        in_schema = p.child.schema
        fixed = _device_common.with_decimal128()
        for s in p.specs:
            in_cols = s.input_cols if p.mode == "partial" \
                else [n for (n, _, _) in s.state_fields]
            for c in in_cols:
                for r in fixed.reasons_not_supported(
                        in_schema.field(c).dtype):
                    meta.cannot_run(f"aggregate input {c}: {r}")
            for (n, d, _) in s.state_fields:
                for r in fixed.reasons_not_supported(d):
                    meta.cannot_run(f"aggregate state {n}: {r}")

    register_exec_rule(
        CpuHashAggregateExec, _device_all,
        lambda p, ch, conf, device: TpuHashAggregateExec(
            ch[0], p.key_names, p.specs, p.mode, device,
            conf.min_bucket_rows,
            "sort" if str(conf.get(GROUPBY_STRATEGY)).lower() == "sort"
            else "hash"),
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

    def tag_bnlj(meta, conf):
        p = meta.plan
        if p.how not in TpuBroadcastNestedLoopJoinExec.SUPPORTED:
            meta.cannot_run(f"join type {p.how} not supported on device BNLJ")

    register_exec_rule(
        CpuBroadcastNestedLoopJoinExec, _device_all,
        lambda p, ch, conf, device: TpuBroadcastNestedLoopJoinExec(
            ch[0], ch[1], p.how, p.condition, device, conf),
        exprs_fn=lambda p: [] if p.condition is None else [p.condition],
        tag_fn=tag_bnlj)

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
    # the exchange: across the session's mesh when one is attached, else
    # one device holds the whole output (exec/exchange.py)
    register_exec_rule(ShuffleExchangeExec, _device_all, _convert_exchange,
                       tag_fn=_tag_exchange)
    _register_relational_rules()


def _active_mesh():
    from ..session import TorchSession
    sess = TorchSession._active
    return sess.shuffle_mesh() if sess is not None else None


def _tag_exchange(meta, conf):
    """The JAX package's ``tag_exchange``: the host tier when forced; the
    mesh tier takes hash partitioning only."""
    p: ShuffleExchangeExec = meta.plan
    mode = conf.get(SHUFFLE_MODE)
    if mode == "host":
        meta.cannot_run("host tier forced (spark.rapids.tpu.shuffle.mode)")
        return
    from ..parallel.runtime import active_cluster
    if active_cluster() is not None:
        return  # the cluster's shuffle managers, or the local tier
    mesh = _active_mesh() if mode in ("auto", "ici") else None
    if mesh is None:
        if mode == "ici":
            meta.cannot_run("shuffle.mode=ici but no device mesh could be "
                            "attached")
        # the local tier: one device partition satisfies any partitioning
        return
    if not isinstance(p.partitioning, HashPartitioning):
        meta.cannot_run(f"{type(p.partitioning).__name__} stays on the host "
                        "tier (only hash partitioning exchanges across the "
                        "mesh)")


def _convert_exchange(p, ch, conf, device):
    from ..parallel.runtime import TpuManagedExchangeExec, active_cluster
    cluster = active_cluster()
    if cluster is not None and isinstance(p.partitioning, HashPartitioning):
        # an in-process cluster runs the query: its shuffle managers carry
        # the exchange (parallel/runtime.py)
        return TpuManagedExchangeExec(ch[0], p.partitioning, cluster,
                                      conf.min_bucket_rows)
    mesh = _active_mesh() if conf.get(SHUFFLE_MODE) in ("auto", "ici") \
        else None
    if mesh is None:
        return TpuLocalExchangeExec(ch[0], p.partitioning,
                                    conf.min_bucket_rows)
    return TpuShuffleExchangeExec(ch[0], p.partitioning, mesh,
                                  conf.min_bucket_rows,
                                  chunk_rows=conf.get(EXCHANGE_CHUNK_ROWS))


#: the window functions the device runs (the JAX package's list)
_DEVICE_WINDOW_FNS = (W.RowNumber, W.Rank, W.DenseRank, W.NTile, W.Lag,
                      W.Lead, A.Sum, A.Min, A.Max, A.Count, A.CountStar,
                      A.Average)


def _register_relational_rules():
    """Range, union, expand, sample, cache and window: the JAX package's
    rules, with its tags and reasons."""
    register_exec_rule(
        CpuRangeExec, _device_all,
        lambda p, ch, conf, device: TpuRangeExec(
            p.start, p.end, p.step, p.num_partitions, conf.min_bucket_rows,
            device))
    register_exec_rule(
        CpuUnionExec, _device_all,
        lambda p, ch, conf, device: TpuUnionExec(ch))
    register_exec_rule(
        CpuExpandExec, _device_all,
        lambda p, ch, conf, device: TpuExpandExec(ch[0], p.projections,
                                                  p.names, p.schema),
        exprs_fn=lambda p: [e for proj in p.projections for e in proj])
    # the most derived rule wins over the filter's in the MRO lookup
    register_exec_rule(
        CpuSampleExec, _device_all,
        lambda p, ch, conf, device: TpuSampleExec(ch[0], p.fraction,
                                                  p.seed))
    register_exec_rule(
        CpuCacheExec, _device_all,
        lambda p, ch, conf, device: TpuCacheExec(ch[0], p.storage, conf))

    def tag_window(meta, conf):
        for _, w in meta.plan.window_cols:
            name = type(w.fn).__name__
            if not isinstance(w.fn, _DEVICE_WINDOW_FNS):
                meta.cannot_run(f"window function {name} not supported on "
                                "device")
                continue
            # the window function is no child expression, so its own kill
            # switch is read here
            fn_key = f"spark.rapids.sql.expression.{name}"
            if not conf.is_op_enabled(fn_key):
                meta.cannot_run(f"window function {name} disabled by "
                                f"{fn_key}")
                continue
            frame = w.spec.frame
            if frame.kind == "range" and not (frame.is_unbounded_entire
                                              or frame.is_running):
                # bounded RANGE offsets apply along one numeric sort axis
                if len(w.spec.orders) != 1:
                    meta.cannot_run("bounded RANGE frames need exactly one "
                                    "order key")
                else:
                    kt = w.spec.orders[0].expr.data_type
                    if not (kt.is_numeric or isinstance(
                            kt, (dt.DateType, dt.TimestampType))):
                        meta.cannot_run(f"bounded RANGE order key {kt!r} "
                                        "not numeric")
            if isinstance(w.fn, (A.Sum, A.Min, A.Max, A.Count, A.Average)) \
                    and w.fn.children \
                    and isinstance(w.fn.children[0].data_type,
                                   (dt.StringType, dt.BinaryType)):
                meta.cannot_run("string aggregate input not supported on "
                                "device window")

    register_exec_rule(
        CpuWindowExec, _device_all,
        lambda p, ch, conf, device: TpuWindowExec(ch[0], p.window_cols),
        exprs_fn=lambda p: [c for _, w in p.window_cols
                            for c in w.fn.children],
        tag_fn=tag_window)


_register_expr_rules()
_register_exec_rules()


# ---------------------------------------------------------------------------
# The DECIMAL_128 tier (the JAX package's plan/overrides.py:886-1040;
# reference: TypeChecks.scala:465,544). Decimals past 18 digits run on the
# device as two-limb int64 columns (expr/decimal128.py); these rules opt
# each op whose device code takes them into the 38-digit gate.
# ---------------------------------------------------------------------------
_D128_OFF = "decimal128 disabled by spark.rapids.sql.decimal128.enabled"


def _plan_has_d128(meta) -> bool:
    return any(dt.is_d128(f.dtype) for f in meta.plan.schema) \
        or any(dt.is_d128(f.dtype) for ch in meta.plan.children
               for f in ch.schema)


def _expr_has_d128(meta) -> bool:
    return dt.is_d128(meta.expr.data_type) \
        or any(dt.is_d128(c.data_type) for c in meta.expr.children)


def _upgrade_decimal128_rules():
    from .meta import EXEC_RULES, EXPR_RULES

    def chain_expr(cls, extra=None):
        rule = EXPR_RULES[cls]
        rule.sig = rule.sig.with_decimal128()
        prev = rule.tag_fn

        def tag(meta, conf):
            if _expr_has_d128(meta):
                if not conf.get(DECIMAL128_ENABLED):
                    meta.cannot_run(_D128_OFF)
                elif extra is not None:
                    extra(meta, conf)
            if prev is not None:
                prev(meta, conf)
        rule.tag_fn = tag

    def agg_fn_ok(meta, conf):
        if not isinstance(meta.expr, (A.Sum, A.Count, A.CountStar,
                                      A.Average, A.First, A.Last)):
            meta.cannot_run(f"{type(meta.expr).__name__} over decimal128 "
                            "is host-only")

    for cls in (AttributeReference, Alias, Literal, Cast,
                AR.Add, AR.Subtract, AR.Multiply, AR.UnaryMinus, AR.Abs,
                P.EqualTo, P.GreaterThan, P.GreaterThanOrEqual, P.LessThan,
                P.LessThanOrEqual, P.IsNull, P.IsNotNull):
        chain_expr(cls)
    for cls in (A.Sum, A.Count, A.CountStar, A.Average, A.First, A.Last):
        chain_expr(cls, agg_fn_ok)

    def chain_exec(cls, extra=None):
        rule = EXEC_RULES[cls]
        rule.output_sig = rule.output_sig.with_decimal128()
        prev = rule.tag_fn

        def tag(meta, conf):
            if _plan_has_d128(meta):
                if not conf.get(DECIMAL128_ENABLED):
                    meta.cannot_run(_D128_OFF)
                elif extra is not None:
                    extra(meta, conf)
            if prev is not None:
                prev(meta, conf)
        rule.tag_fn = tag

    def agg_ok(meta, conf):
        for s in meta.plan.specs:
            for ops in (s.update_ops, s.merge_ops):
                for op, (n, d, _) in zip(ops, s.state_fields):
                    if dt.is_d128(d) and op not in ("sum", "count", "first",
                                                    "last"):
                        meta.cannot_run(
                            f"aggregate op {op!r} over decimal128 state "
                            f"{n} is host-only")

    for cls in (CpuScanExec, CpuProjectExec, CpuFilterExec, CpuSortExec,
                CpuTakeOrderedExec, CpuGlobalLimitExec, CpuLocalLimitExec,
                CpuCollectLimitExec, CpuUnionExec, CpuExpandExec,
                ShuffleExchangeExec, CpuShuffledHashJoinExec,
                CpuBroadcastHashJoinExec):
        chain_exec(cls)
    chain_exec(CpuHashAggregateExec, agg_ok)


_upgrade_decimal128_rules()


def explain_plan(cpu_plan: PhysicalPlan, conf: RapidsConf,
                 device: torch.device = torch.device("cpu")) -> str:
    meta = wrap_plan(cpu_plan)
    meta.tag(conf)
    plan_quarantine_pass(meta, conf, device)
    return meta.explain(not_on_device_only=(conf.explain == "NOT_ON_GPU"))


def apply_overrides(cpu_plan: PhysicalPlan, conf: RapidsConf,
                    device: torch.device) -> PhysicalPlan:
    """Tag + convert + insert transitions + fuse (SURVEY §3.2 call stack)."""
    meta = wrap_plan(cpu_plan)
    meta.tag(conf)
    # operators the runtime fallback quarantined run on the host engine
    plan_quarantine_pass(meta, conf, device)
    if conf.explain != "NONE":
        text = meta.explain(not_on_device_only=(conf.explain == "NOT_ON_GPU"))
        if text:
            print(text)
    if conf.test_enabled:
        for m in meta.walk():
            # a quarantined node is deliberate host routing (its runtime
            # failure history), not a support gap
            if m.reasons and all(r.startswith("quarantined:")
                                 for r in m.reasons):
                continue
            # a scan that cannot decode on the device reads on the host
            if not m.can_run and not isinstance(m.plan, CpuScanExec):
                raise AssertionError(
                    f"[test.enabled] {type(m.plan).__name__} fell off the "
                    f"device: {m.reasons}")
    converted = meta.convert_if_needed(conf, device)
    fused = fuse_stages(insert_transitions(converted, conf, device),
                        donation_active(conf, device))
    # after fusion, so a fused stage fed by a mesh exchange runs over
    # every shard at once (exec/mesh.py)
    from ..exec.mesh import plan_mesh_stages
    return plan_mesh_stages(fused, conf)
