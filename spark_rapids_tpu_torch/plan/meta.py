"""Meta/tagging framework — the port of ``spark_rapids_tpu/plan/meta.py``
(reference: RapidsMeta.scala:74,547,927).

Wraps a host physical plan into a parallel meta-tree; ``tag`` marks each
node and expression convertible-or-not with recorded reasons;
``convert_if_needed`` then builds the device plan for convertible subtrees.
Per-op enable flags are derived from rule names
(``spark.rapids.sql.exec.<Name>`` / ``spark.rapids.sql.expression.<Name>``)
like ExecRule/ExprRule.confKey in GpuOverrides.scala:211-303.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Type

import torch

from ..columnar.dtypes import TypeSig
from ..conf import RapidsConf
from ..expr.base import Expression
from .physical import PhysicalPlan

__all__ = ["ExprMeta", "ExecMeta", "ExprRule", "ExecRule",
           "EXPR_RULES", "EXEC_RULES", "register_expr_rule",
           "register_exec_rule", "wrap_plan"]

#: the reason an operator or expression without a device rule carries
NOT_PORTED = "is not ported to the device yet (ROADMAP Queue 1)"


class BaseMeta:
    def __init__(self):
        self.reasons: List[str] = []

    def cannot_run(self, reason: str):
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_run(self) -> bool:
        return not self.reasons


class ExprMeta(BaseMeta):
    def __init__(self, expr: Expression, rule: "Optional[ExprRule]"):
        super().__init__()
        self.expr = expr
        self.rule = rule
        self.children = [wrap_expr(c) for c in expr.children]

    def tag(self, conf: RapidsConf):
        for c in self.children:
            c.tag(conf)
        name = type(self.expr).__name__
        if self.rule is None:
            self.cannot_run(f"expression {name} {NOT_PORTED}")
            return
        if not conf.is_op_enabled(self.rule.conf_key):
            self.cannot_run(f"expression {name} disabled by {self.rule.conf_key}")
            return
        self.rule.tag(self, conf)
        for c in self.children:
            if not c.can_run:
                self.cannot_run(
                    f"child expression {type(c.expr).__name__} cannot run: "
                    + "; ".join(c.reasons))


class ExecMeta(BaseMeta):
    def __init__(self, plan: PhysicalPlan, rule: "Optional[ExecRule]"):
        super().__init__()
        self.plan = plan
        self.rule = rule
        self.children = [wrap_plan(c) for c in plan.children]
        self.expr_metas: List[ExprMeta] = [
            wrap_expr(e) for e in (rule.exprs_of(plan) if rule else [])]

    def tag(self, conf: RapidsConf):
        for c in self.children:
            c.tag(conf)
        name = type(self.plan).__name__
        if self.rule is None:
            self.cannot_run(f"{name} {NOT_PORTED}")
            return
        if not conf.is_op_enabled(self.rule.conf_key):
            self.cannot_run(f"{name} disabled by {self.rule.conf_key}")
            return
        for f in self.plan.schema:
            for r in self.rule.output_sig.reasons_not_supported(f.dtype):
                self.cannot_run(f"output column {f.name}: {r}")
        # a host->device transition uploads the whole child batch, so
        # unsupported child columns block device lowering (reference:
        # ExecChecks input sigs, TypeChecks.scala:702)
        for child_plan in self.plan.children:
            for f in child_plan.schema:
                for r in self.rule.output_sig.reasons_not_supported(f.dtype):
                    self.cannot_run(f"input column {f.name}: {r}")
        for em in self.expr_metas:
            em.tag(conf)
            if not em.can_run:
                self.cannot_run(f"expression {em.expr!r} cannot run: "
                                + "; ".join(em.reasons))
        self.rule.tag(self, conf)

    def convert_if_needed(self, conf: RapidsConf,
                          device: torch.device) -> PhysicalPlan:
        new_children = [c.convert_if_needed(conf, device)
                        for c in self.children]
        if self.can_run and self.rule is not None:
            return self.rule.convert_fn(self.plan, new_children, conf, device)
        return replace_children(self.plan, new_children)

    def explain(self, indent: int = 0, not_on_device_only: bool = False) -> str:
        pad = "  " * indent
        name = type(self.plan).__name__
        lines = []
        if self.can_run:
            if not not_on_device_only:
                lines.append(f"{pad}* {name} will run on the device")
        else:
            lines.append(f"{pad}! {name} cannot run on the device because "
                         + "; ".join(self.reasons))
        for c in self.children:
            sub = c.explain(indent + 1, not_on_device_only)
            if sub:
                lines.append(sub)
        return "\n".join(lines)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class ExprRule:
    def __init__(self, cls: Type[Expression], sig: TypeSig,
                 tag_fn: Optional[Callable[[ExprMeta, RapidsConf], None]] = None):
        self.cls = cls
        self.sig = sig
        self.tag_fn = tag_fn
        self.conf_key = f"spark.rapids.sql.expression.{cls.__name__}"

    def tag(self, meta: ExprMeta, conf: RapidsConf):
        e = meta.expr
        for r in self.sig.reasons_not_supported(e.data_type):
            meta.cannot_run(f"output: {r}")
        for c in e.children:
            for r in self.sig.reasons_not_supported(c.data_type):
                meta.cannot_run(f"input {type(c).__name__}: {r}")
        if self.tag_fn is not None:
            self.tag_fn(meta, conf)


class ExecRule:
    def __init__(self, cls: Type[PhysicalPlan], output_sig: TypeSig,
                 convert_fn: Callable[..., PhysicalPlan],
                 exprs_fn: Optional[Callable[[PhysicalPlan],
                                             Sequence[Expression]]] = None,
                 tag_fn: Optional[Callable[[ExecMeta, RapidsConf], None]] = None):
        self.cls = cls
        self.output_sig = output_sig
        #: (host plan, converted children, conf, device) -> device plan
        self.convert_fn = convert_fn
        self.exprs_fn = exprs_fn
        self.tag_fn = tag_fn
        self.conf_key = f"spark.rapids.sql.exec.{cls.__name__.replace('Cpu', '')}"

    def exprs_of(self, plan: PhysicalPlan) -> Sequence[Expression]:
        return self.exprs_fn(plan) if self.exprs_fn else []

    def tag(self, meta: ExecMeta, conf: RapidsConf):
        if self.tag_fn is not None:
            self.tag_fn(meta, conf)


EXPR_RULES: Dict[type, ExprRule] = {}
EXEC_RULES: Dict[type, ExecRule] = {}


def register_expr_rule(cls, sig: TypeSig, tag_fn=None) -> ExprRule:
    rule = ExprRule(cls, sig, tag_fn)
    EXPR_RULES[cls] = rule
    return rule


def register_exec_rule(cls, output_sig: TypeSig, convert_fn, exprs_fn=None,
                       tag_fn=None) -> ExecRule:
    rule = ExecRule(cls, output_sig, convert_fn, exprs_fn, tag_fn)
    EXEC_RULES[cls] = rule
    return rule


def _rule_for(obj, rules: Dict[type, object]):
    for cls in type(obj).__mro__:  # rules may be registered on base classes
        if cls in rules:
            return rules[cls]
    return None


def wrap_expr(e: Expression) -> ExprMeta:
    return ExprMeta(e, _rule_for(e, EXPR_RULES))


def wrap_plan(p: PhysicalPlan) -> ExecMeta:
    return ExecMeta(p, _rule_for(p, EXEC_RULES))


def replace_children(plan: PhysicalPlan,
                     children: List[PhysicalPlan]) -> PhysicalPlan:
    """Point ``plan`` at new children (in place; plans are single-use)."""
    if list(plan.children) == list(children):
        return plan
    plan.children = tuple(children)
    if hasattr(plan, "child") and len(children) == 1:
        plan.child = children[0]
    return plan
