"""TorchSession + DataFrame — the user entry point; the port of
``spark_rapids_tpu/session.py``.

Holds the RapidsConf and the torch device queries run on, and drives
logical -> physical -> overrides -> execution. A device plan that holds an
exchange runs under adaptive execution (plan/aqe.py) unless
``spark.rapids.tpu.aqe.enabled`` is off. A projection's window expressions
become window nodes below it, one a (partition, order) spec; rollup, cube
and grouping sets aggregate over an Expand; a result can stay on the
device (``to_device_batches``, ``to_torch``).

A session configures the process-wide robustness layer when it starts, as
the JAX session does: the memory profiler (utils/memprof.py), fault
injection (utils/faults.py), the OOM ladder's bounds (memory/retry.py), the
host fallback and its quarantine (exec/fallback.py), the task semaphore's
permits (memory/semaphore.py), the pipelined collect (parallel/pipeline.py)
and, when the session sets a pool key, a buffer catalog of its own
(memory/catalog.py ``bind_catalog``). ``collect`` drains the partitions
through the pipelined collect, under the query deadline
(utils/deadline.py).
"""
from __future__ import annotations

import itertools
import random
from typing import Dict, List, Optional, Union

import pyarrow as pa
import torch

from .columnar import dtypes as dt
from .columnar.device import (DeviceTable, concat_device_tables,
                              resolve_device, shrink_to_fit)
from .conf import AQE_ENABLED, RapidsConf
from .exec.transitions import DeviceToHostExec
from .expr.base import Alias, AttributeReference, Expression, Literal
from .expr.decimal128 import d128_to_f64
from .expr.functions import SortOrder, _to_expr, col as _col, count_star
from .expr.subquery import ScalarSubquery
from .io.memory import InMemorySource
from .io.parquet import ParquetSource
from .plan.aqe import AdaptiveExec, walk_plan
from .plan.logical import (LogicalAggregate, LogicalCache, LogicalExpand,
                           LogicalFilter, LogicalJoin, LogicalLimit,
                           LogicalPlan, LogicalProject, LogicalRange,
                           LogicalSample, LogicalScan, LogicalSort,
                           LogicalUnion, LogicalWindow)
from .plan.overrides import apply_overrides, explain_plan
from .plan.physical import (PLAN_EXPR_ATTRS, PhysicalPlan,
                            ShuffleExchangeExec)
from .plan.planner import plan_physical
from .plan.schema import Schema

__all__ = ["TorchSession", "DataFrame", "GroupedData"]

#: the ids of collects, for the memory profiler's per-query attribution
_QUERY_IDS = itertools.count(1)


class TorchSession:
    """A session whose device plans run on ``device`` (default ``"cuda"``).

    A session asked for CUDA on a machine without a usable CUDA device
    raises: it never carries on on the CPU unless the caller asked for
    ``device="cpu"``. ``attach_mesh`` gives it a device mesh
    (parallel/mesh.py), across which its hash exchanges then run.
    """

    #: the session that plans and executes now (the planner asks it for
    #: the mesh, as the JAX package's planner does)
    _active: Optional["TorchSession"] = None

    def __init__(self, conf: Optional[Union[RapidsConf, Dict]] = None,
                 device: Union[str, torch.device] = "cuda"):
        if isinstance(conf, dict):
            conf = RapidsConf(conf)
        self.conf = conf or RapidsConf()
        self.device = resolve_device(device, "TorchSession")
        from .exec.fallback import configure_fallback
        from .memory.catalog import bind_catalog
        from .memory.retry import configure_oom_retry
        from .memory.semaphore import get_semaphore
        from .utils.faults import configure_faults
        from .utils.memprof import configure_memprof
        # the memory flight recorder: buffer-lifecycle attribution, leak
        # scans and OOM postmortems (the catalog emits into it)
        configure_memprof(self.conf)
        # fault injection: install or clear the process-wide injector
        # behind the named fault points (None unless faults.enabled)
        configure_faults(self.conf)
        # the shuffle observatory: install or clear the process-wide
        # per-tier transfer telemetry (None unless telemetry.enabled)
        from .shuffle.telemetry import configure_shuffle_telemetry
        configure_shuffle_telemetry(self.conf)
        # the OOM ladder's bounds and arbitration
        configure_oom_retry(self.conf)
        # the runtime host fallback and the operator quarantine store
        configure_fallback(self.conf)
        # a session that sets a pool key gets a catalog of those settings
        bind_catalog(self.conf, self.device)
        # concurrentGpuTasks permits
        get_semaphore(self.conf)
        #: the memory profiler's summary of the last collect (None while
        #: profiling is off): peak holders by operator and leaked buffers
        self.last_memory_summary = None
        from .parallel.pipeline import configure_pipeline
        # the pipelined collect's switch, queue depth and task pool
        configure_pipeline(self.conf)
        self._mesh = None
        TorchSession._active = self

    # -- the device mesh (the exchange tier across devices) ------------------
    def attach_mesh(self, mesh) -> "TorchSession":
        """Attach a ``parallel.mesh.Mesh``: hash exchanges then run across
        it (exec/exchange.py ``TpuShuffleExchangeExec``)."""
        self._mesh = mesh
        return self

    def shuffle_mesh(self):
        """The mesh the planner may exchange across, or None (the local
        tier). ``shuffle.mode=host`` turns the device tiers off; ``ici``
        builds a mesh over every visible card on first use; ``auto`` takes
        the attached mesh. A mesh of fewer than two shards is the local
        tier."""
        from .conf import SHUFFLE_MODE
        mode = self.conf.get(SHUFFLE_MODE)
        if mode == "host":
            return None
        if self._mesh is None and mode == "ici" \
                and self.device.type == "cuda":
            from .parallel.mesh import data_parallel_mesh
            self._mesh = data_parallel_mesh()
        if self._mesh is not None and self._mesh.size < 2:
            return None
        return self._mesh

    def create_dataframe(self, data, num_partitions: int = 1) -> "DataFrame":
        if isinstance(data, pa.Table):
            table = data
        elif isinstance(data, dict):
            table = pa.table(data)
        else:  # pandas
            table = pa.Table.from_pandas(data, preserve_index=False)
        return DataFrame(self, LogicalScan(InMemorySource(table,
                                                          num_partitions)))

    def read_parquet(self, paths, num_partitions: Optional[int] = None
                     ) -> "DataFrame":
        """A DataFrame over Parquet files (a file, a directory of
        ``*.parquet`` or a glob; partitioned by file)."""
        return DataFrame(self, LogicalScan(
            ParquetSource(paths, self.conf, num_partitions)))

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1) -> "DataFrame":
        """A DataFrame of one LONG column ``id``: ``start`` up to ``end``
        (exclusive) by ``step``; ``range(n)`` is ``range(0, n)``."""
        if end is None:
            start, end = 0, start
        return DataFrame(self, LogicalRange(start, end, step,
                                            num_partitions))

    def _physical(self, logical: LogicalPlan,
                  device: Optional[bool] = None) -> PhysicalPlan:
        TorchSession._active = self
        cpu = plan_physical(logical, self.conf)
        use_device = self.conf.is_sql_enabled if device is None else device
        # scalar subqueries run first, on the same engine, and enter the
        # main plan as literals (so AQE plans it with the value in place)
        _bind_subqueries(cpu, self, device)
        if not use_device:
            return cpu
        if self.conf.get(AQE_ENABLED) and any(
                isinstance(n, ShuffleExchangeExec) for n in walk_plan(cpu)):
            # stages materialize and the rest re-plans at each exchange
            return AdaptiveExec(cpu, self.conf, self.device)
        return apply_overrides(cpu, self.conf, self.device)

    def set_conf(self, key: str, value) -> "TorchSession":
        self.conf = self.conf.set(key, value)
        return self


class DataFrame:
    def __init__(self, session: TorchSession, logical: LogicalPlan):
        self.session = session
        self.logical = logical

    @property
    def schema(self) -> Schema:
        return self.logical.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    # -- transformations -----------------------------------------------------
    def select(self, *cols) -> "DataFrame":
        return self._project_with_windows([self._col_expr(c) for c in cols])

    def with_column(self, name: str, c) -> "DataFrame":
        exprs: List[Expression] = [
            AttributeReference(n) for n in self.schema.names if n != name]
        exprs.append(Alias(_to_expr(c), name))
        return self._project_with_windows(exprs)

    def _project_with_windows(self, exprs: List[Expression]) -> "DataFrame":
        """A projection whose top-level window expressions are pulled into
        window nodes, one a distinct (partition, order) spec, below it
        (reference: GpuWindowExec's pre and post projections)."""
        from .expr.window import WindowExpression

        def top_window(e):
            if isinstance(e, WindowExpression):
                return e
            if isinstance(e, Alias) and isinstance(e.child,
                                                   WindowExpression):
                return e.child
            return None

        items = []
        final: List[Expression] = []
        for i, e in enumerate(exprs):
            w = top_window(e)
            if w is None:
                if any(isinstance(x, WindowExpression)
                       for x in _walk_expr(e)):
                    raise NotImplementedError(
                        "window expressions nested inside other expressions "
                        "are not supported yet; alias the window column "
                        "first")
                final.append(e)
            else:
                # an internal name: the window column may replace a column
                # of the same name (with_column("x", ...over(w)))
                target = e.name if isinstance(e, Alias) else f"_w{i}"
                internal = f"__win{i}_{target}"
                items.append((internal, w))
                final.append(Alias(AttributeReference(internal), target))
        if not items:
            return DataFrame(self.session,
                             LogicalProject(self.logical, exprs))
        groups: Dict[tuple, list] = {}
        for name, w in items:
            key = (tuple(repr(p) for p in w.spec.partition_exprs),
                   tuple((repr(o.expr), o.ascending, o.nulls_first)
                         for o in w.spec.orders))
            groups.setdefault(key, []).append((name, w))
        base = self.logical
        for group in groups.values():
            base = LogicalWindow(base, group)
        return DataFrame(self.session, LogicalProject(base, final))

    def filter(self, cond) -> "DataFrame":
        return DataFrame(self.session,
                         LogicalFilter(self.logical, _to_expr(cond)))

    where = filter

    def agg(self, *aggs) -> "DataFrame":
        """Aggregate over all rows (no grouping keys)."""
        return GroupedData(self, []).agg(*aggs)

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, [self._col_expr(c) for c in cols])

    groupBy = group_by

    def rollup(self, *cols) -> "GroupedData":
        """Hierarchical grouping sets: rollup(a, b) aggregates by (a, b),
        (a) and (), through an Expand node (reference: GpuExpandExec)."""
        names = self._grouping_names(cols)
        sets = [names[:i] for i in range(len(names), -1, -1)]
        return GroupedData(self, [self._col_expr(c) for c in cols], sets)

    def cube(self, *cols) -> "GroupedData":
        """Every one of the 2^k combinations of the columns."""
        names = self._grouping_names(cols)
        sets = [list(c) for r in range(len(names), -1, -1)
                for c in itertools.combinations(names, r)]
        return GroupedData(self, [self._col_expr(c) for c in cols], sets)

    def grouping_sets(self, sets, *cols) -> "GroupedData":
        """Explicit GROUPING SETS over ``cols``; each set is a list of
        names drawn from ``cols``."""
        names = self._grouping_names(cols)
        for st in sets:
            unknown = set(st) - set(names)
            if unknown:
                raise ValueError(f"grouping set references {unknown} not in "
                                 f"grouping columns {names}")
        return GroupedData(self, [self._col_expr(c) for c in cols],
                           [list(st) for st in sets])

    def _grouping_names(self, cols) -> List[str]:
        names = []
        for c in cols:
            e = self._col_expr(c)
            if not isinstance(e, AttributeReference):
                raise TypeError(
                    "rollup/cube/grouping_sets take column references, "
                    f"got {e!r} (pre-project expressions with select())")
            names.append(e.column_name)
        return names

    def sample(self, fraction: float, seed=None) -> "DataFrame":
        """A deterministic Bernoulli row sample (reference: SampleExec and
        GpuPoissonSampler): a seed keeps the same rows on the device and
        the host engine."""
        if seed is None:
            seed = random.randrange(2 ** 31)
        return DataFrame(self.session,
                         LogicalSample(self.logical, fraction, seed))

    def cache(self) -> "DataFrame":
        """This DataFrame, materialized on its first run and served from
        the cache afterwards (on the device: spillable batches)."""
        return DataFrame(self.session, LogicalCache(self.logical))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL (Spark's ``union``): the columns by position."""
        return DataFrame(self.session,
                         LogicalUnion([self.logical, other.logical]))

    union_all = union

    def sort(self, *orders, ascending: bool = True) -> "DataFrame":
        """A global sort by column names, Columns or ``SortOrder``s (names
        and Columns sort ``ascending``, with Spark's default null order)."""
        sos = [o if isinstance(o, SortOrder)
               else SortOrder(self._col_expr(o), ascending) for o in orders]
        return DataFrame(self.session, LogicalSort(self.logical, sos))

    order_by = orderBy = sort

    def distinct(self) -> "DataFrame":
        """Row dedup = zero-aggregate group-by over all columns (the
        planner lowers it to the grouped aggregate's key dedup)."""
        return DataFrame(self.session, LogicalAggregate(
            self.logical, [self._col_expr(n) for n in self.columns], []))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, LogicalLimit(self.logical, n))

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Join ``other`` on same-named columns ``on`` (output once) or on a
        ``condition`` whose equalities between the two sides are the keys
        (the rest is the residual condition). The device runs every hash
        join type on keys of any ported type but binary; a join without
        equi-keys runs as the broadcast nested-loop join."""
        if isinstance(on, str):
            on = [on]
        cond = _to_expr(condition) if condition is not None else None
        return DataFrame(self.session, LogicalJoin(self.logical,
                                                   other.logical, on, cond,
                                                   how))

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        """Every row of this DataFrame with every row of ``other`` (the
        broadcast nested-loop join, ``other`` broadcast)."""
        return DataFrame(self.session, LogicalJoin(self.logical,
                                                   other.logical, None, None,
                                                   "cross"))

    def _col_expr(self, c) -> Expression:
        return _to_expr(_col(c) if isinstance(c, str) else c)

    # -- actions -------------------------------------------------------------
    def collect(self, device: Optional[bool] = None) -> pa.Table:
        """Run the query: on the session's device (``device=True``, the
        default when SQL is enabled) or on the host engine
        (``device=False``), under ``spark.rapids.tpu.query.timeoutSeconds``
        (a QueryTimeoutError at the first checkpoint past it)."""
        from .conf import QUERY_TIMEOUT
        from .utils import memprof
        from .utils.deadline import deadline_scope
        from .utils.node_context import query_scope
        qid = next(_QUERY_IDS)
        mp = memprof.active()
        if mp is not None:
            mp.begin_query(qid)
        from .parallel.pipeline import configure_pipeline, pipelined_collect
        configure_pipeline(self.session.conf)
        plan = self.session._physical(self.logical, device)
        try:
            with deadline_scope(self.session.conf.get(QUERY_TIMEOUT)), \
                    query_scope(qid):
                # partitions drain concurrently under the task semaphore
                # (parallel/pipeline.py); sequential with pipeline.enabled
                # off or one partition
                return pipelined_collect(plan, self.session.conf).to_arrow()
        finally:
            # the plan is single-use: close its spill-registered outputs
            # (broadcast builds, grace parts) now rather than at GC
            plan.release_spill_handles()
            if mp is not None:
                # the query's memory summary: peak holders by operator and
                # the buffers still registered after it (leaks)
                self.session.last_memory_summary = mp.query_end(qid)

    def to_pandas(self, device: Optional[bool] = None):
        return self.collect(device).to_pandas()

    def count(self) -> int:
        return self.agg(count_star().alias("n")).collect() \
            .column("n")[0].as_py()

    # -- results left on the device (reference: ColumnarRdd.scala:42,51, the
    # handoff of a DataFrame's device batches to ML consumers) -------------
    def _batches_from_plan(self, plan: PhysicalPlan, pidx: int):
        if isinstance(plan, AdaptiveExec):
            plan = plan.final_plan()
        if isinstance(plan, DeviceToHostExec):
            yield from plan.child.execute_columnar(pidx)
            return
        # a plan that stayed on the host: each batch uploaded
        for ht in plan.execute(pidx):
            yield DeviceTable.from_host(ht, self.session.conf.min_bucket_rows,
                                        self.session.device)

    def _device_plan(self) -> PhysicalPlan:
        """The device plan, kept per configuration snapshot: iterating the
        partitions must not plan again."""
        cached = getattr(self, "_dev_plan_cache", None)
        if cached is not None and cached[0] is self.session.conf:
            return cached[1]
        plan = self.session._physical(self.logical, True)
        self._dev_plan_cache = (self.session.conf, plan)
        return plan

    def to_device_batches(self, pidx: int):
        """The ``DeviceTable`` batches of one partition, left on the
        session's device (no host round trip)."""
        yield from self._batches_from_plan(self._device_plan(), pidx)

    def num_partitions(self) -> int:
        return self._device_plan().num_partitions

    def to_torch(self, columns=None, allow_nulls: bool = False
                 ) -> Dict[str, object]:
        """The result as a dict of tensors on the session's device, cut to
        the row count (the JAX package's ``to_jax``). A numeric, boolean,
        date or timestamp column is one tensor; a decimal column its values
        as float64; a string column a (byte matrix, lengths) pair. A column
        with nulls raises unless ``allow_nulls``, which adds a
        ``<name>__validity`` mask."""
        plan = self.session._physical(self.logical, True)   # planned once
        batches = [b for p in range(plan.num_partitions)
                   for b in self._batches_from_plan(plan, p)]
        if not batches:
            raise ValueError("empty DataFrame")
        table = concat_device_tables(batches) if len(batches) > 1 \
            else batches[0].compact()
        table = shrink_to_fit(table, self.session.conf.min_bucket_rows)
        n = int(table.num_rows)
        out: Dict[str, object] = {}
        for name, c in zip(table.names, table.columns):
            if columns is not None and name not in columns:
                continue
            if not bool(c.validity[:n].all()):
                if not allow_nulls:
                    raise ValueError(
                        f"column {name!r} contains nulls; pass "
                        "allow_nulls=True to receive a validity mask")
                out[f"{name}__validity"] = c.validity[:n]
            if c.lengths is not None:
                out[name] = (c.data[:n], c.lengths[:n])
            elif isinstance(c.dtype, dt.DecimalType):
                # the values, not the scaled integers
                v = d128_to_f64(c.data[:n]) if dt.is_d128(c.dtype) \
                    else c.data[:n].to(torch.float64)
                out[name] = v / (10.0 ** c.dtype.scale)
            else:
                out[name] = c.data[:n]
        return out

    def explain(self, mode: str = "plan") -> str:
        """``"plan"``: the physical plan that runs; ``"device"``: the tagging
        report — each host node and whether, or why not, it runs on the
        device."""
        if mode == "device":
            text = explain_plan(plan_physical(self.logical,
                                              self.session.conf),
                                self.session.conf, self.session.device)
        else:
            text = self.session._physical(self.logical).tree_string()
        print(text)
        return text


class GroupedData:
    """``DataFrame.group_by(...)`` (or rollup, cube, grouping_sets): the
    grouping keys, waiting for ``agg``."""

    def __init__(self, df: DataFrame, groupings: List[Expression],
                 grouping_sets: Optional[List[List[str]]] = None):
        self.df = df
        self.groupings = groupings
        self.grouping_sets = grouping_sets

    def agg(self, *aggs) -> DataFrame:
        exprs = [_to_expr(a) for a in aggs]
        if self.grouping_sets is not None:
            return self._agg_grouping_sets(exprs)
        return DataFrame(self.df.session, LogicalAggregate(
            self.df.logical, self.groupings, exprs))

    def count(self) -> DataFrame:
        return self.agg(count_star().alias("count"))

    def _agg_grouping_sets(self, aggs: List[Expression]) -> DataFrame:
        """rollup, cube and grouping sets: Expand (a projection a set, its
        absent grouping columns null, and a grouping id, so a null value of
        the data stays apart from an aggregated-away column) -> aggregate
        -> drop the id (Spark's Aggregate over Expand).

        An aggregate that reads a grouping column reads an un-nulled copy
        of it, as Spark: rollup('a').agg(sum('a')) sums the real values in
        the rows where 'a' is aggregated away too."""
        cs = self.df.logical.schema
        gnames = [g.column_name for g in self.groupings]
        refs = {r for a in aggs for r in a.references()}
        others = sorted(refs - set(gnames))
        copied = sorted(refs & set(gnames))
        copy_name = {g: f"__gset_input_{g}__" for g in copied}
        aggs = [_replace_refs(a, copy_name) for a in aggs]
        gid_name = "__grouping_id__"
        k = len(gnames)
        projections = []
        for st in self.grouping_sets:
            # Spark's grouping id: bit (k-1-i) set when column i is
            # aggregated away in this set
            gid = sum(1 << (k - 1 - i) for i, g in enumerate(gnames)
                      if g not in st)
            proj: List[Expression] = [
                AttributeReference(g, cs.field(g).dtype) if g in st
                else Literal(None, cs.field(g).dtype) for g in gnames]
            proj += [AttributeReference(o, cs.field(o).dtype)
                     for o in others]
            proj += [AttributeReference(g, cs.field(g).dtype)
                     for g in copied]
            proj.append(Literal(gid))
            projections.append(proj)
        expand = LogicalExpand(
            self.df.logical, projections,
            gnames + others + [copy_name[g] for g in copied] + [gid_name])
        agg = LogicalAggregate(
            expand, [_col(g).expr for g in gnames] + [_col(gid_name).expr],
            aggs)
        out = [n for n in agg.schema.names if n != gid_name]
        return DataFrame(self.df.session, LogicalProject(
            agg, [_col(n).expr for n in out]))


def _walk_expr(e: Expression):
    yield e
    for c in e.children:
        yield from _walk_expr(c)


def _replace_refs(e: Expression, mapping: Dict[str, str]) -> Expression:
    """Renames the AttributeReferences of a tree by ``mapping``."""
    if isinstance(e, AttributeReference):
        if e.column_name in mapping:
            return AttributeReference(mapping[e.column_name], e._dtype,
                                      e._nullable)
        return e
    if not e.children:
        return e
    return e.with_children([_replace_refs(c, mapping) for c in e.children])


def _bind_subqueries(plan: PhysicalPlan, session: TorchSession,
                     device: Optional[bool]) -> None:
    """Run every scalar subquery of ``plan`` (in the session, before the main
    query — reference: ExecSubqueryExpression / GpuScalarSubquery) and put
    its value in the plan as a typed literal."""

    def bind(e: Expression) -> Expression:
        if isinstance(e, ScalarSubquery):
            return e.to_literal(session, device)
        if e.children:
            new = [bind(c) for c in e.children]
            if any(n is not o for n, o in zip(new, e.children)):
                e = e.with_children(new)
        return e

    def bind_any(v):
        if isinstance(v, Expression):
            return bind(v)
        if isinstance(v, list):
            return [bind_any(x) for x in v]
        if isinstance(v, tuple) and len(v) == 2 \
                and isinstance(v[1], Expression):   # a window column
            return (v[0], bind(v[1]))
        if isinstance(v, SortOrder):  # shared with the exchange's bounds
            v.expr = bind(v.expr)
        return v

    for node in walk_plan(plan):
        for attr in PLAN_EXPR_ATTRS:
            v = getattr(node, attr, None)
            if v is not None:
                setattr(node, attr, bind_any(v))
