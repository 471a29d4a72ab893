"""Conditional expressions — the port of
``spark_rapids_tpu/expr/conditional.py`` (reference:
conditionalExpressions.scala, nullExpressions.scala Coalesce)."""
from __future__ import annotations

from typing import List, Tuple

from ..columnar import dtypes as dt
from .arithmetic import numeric_promote
from .base import EvalCol, EvalContext, Expression
from .cast import Cast

__all__ = ["If", "CaseWhen", "Coalesce", "NullIf", "Nvl"]


def _common_type(types: List[dt.DataType]) -> dt.DataType:
    out = None
    for t in types:
        if isinstance(t, dt.NullType):
            continue
        out = t if out is None else (out if out == t else numeric_promote(out, t))
    return out if out is not None else dt.NULL


def _select(ctx: EvalContext, cond_vals, cond_validity, then: EvalCol, els: EvalCol,
            out_type: dt.DataType) -> EvalCol:
    xp = ctx.xp
    take_then = cond_vals if cond_validity is None \
        else xp.logical_and(cond_vals, cond_validity)
    values = xp.where(take_then, then.values, els.values)
    tvalid = then.valid_mask(ctx)
    evalid = els.valid_mask(ctx)
    validity = xp.where(take_then, tvalid, evalid)
    if then.validity is None and els.validity is None:
        validity = None
    return EvalCol(values, validity, out_type)


class If(Expression):
    def __init__(self, predicate: Expression, then: Expression, els: Expression):
        self.predicate, self.then, self.els = predicate, then, els
        self.children = (predicate, then, els)

    def coerce(self):
        common = _common_type([self.then.data_type, self.els.data_type])
        then = self.then if self.then.data_type == common else Cast(self.then, common)
        els = self.els if self.els.data_type == common else Cast(self.els, common)
        if isinstance(self.then.data_type, dt.NullType):
            then = self.then  # Literal(None) eval adapts via out dtype cast below
            then = Cast(self.then, common) if common != dt.NULL else self.then
        return If(self.predicate, then, els)

    @property
    def data_type(self):
        return _common_type([self.then.data_type, self.els.data_type])

    def eval(self, ctx: EvalContext) -> EvalCol:
        p = self.predicate.eval(ctx)
        t = self.then.eval(ctx)
        e = self.els.eval(ctx)
        return _select(ctx, p.values, p.validity, t, e, self.data_type)


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2 ...] [ELSE ve] END."""

    def __init__(self, *branches_and_else: Expression):
        # flat children: [c1, v1, c2, v2, ..., (optional) else]
        self.flat = tuple(branches_and_else)
        self.children = self.flat

    def with_children(self, children):
        return CaseWhen(*children)

    @property
    def _parts(self) -> Tuple[List[Tuple[Expression, Expression]], Expression]:
        n = len(self.flat)
        pairs = [(self.flat[i], self.flat[i + 1]) for i in range(0, n - (n % 2), 2)]
        els = self.flat[-1] if n % 2 == 1 else None
        return pairs, els

    def coerce(self):
        from .base import Literal
        pairs, els = self._parts
        value_types = [v.data_type for _, v in pairs]
        if els is not None:
            value_types.append(els.data_type)
        common = _common_type(value_types)
        flat = []
        for c, v in pairs:
            flat += [c, v if v.data_type == common else Cast(v, common)]
        if els is None:
            els = Literal(None, common)
        flat.append(els if els.data_type == common else Cast(els, common))
        return CaseWhen(*flat)

    @property
    def data_type(self):
        pairs, els = self._parts
        ts = [v.data_type for _, v in pairs]
        if els is not None:
            ts.append(els.data_type)
        return _common_type(ts)

    def eval(self, ctx: EvalContext) -> EvalCol:
        pairs, els = self._parts
        assert els is not None, "coerce() must run before eval"
        out = els.eval(ctx)
        for cond, val in reversed(pairs):
            c = cond.eval(ctx)
            v = val.eval(ctx)
            out = _select(ctx, c.values, c.validity, v, out, self.data_type)
        return out


class Coalesce(Expression):
    def __init__(self, *exprs: Expression):
        self.children = tuple(exprs)

    def with_children(self, children):
        return Coalesce(*children)

    def coerce(self):
        common = _common_type([c.data_type for c in self.children])
        return Coalesce(*[c if c.data_type == common else Cast(c, common)
                          for c in self.children])

    @property
    def data_type(self):
        return _common_type([c.data_type for c in self.children])

    def eval(self, ctx: EvalContext) -> EvalCol:
        out = self.children[-1].eval(ctx)
        for e in reversed(self.children[:-1]):
            c = e.eval(ctx)
            valid = c.valid_mask(ctx)
            out = _select(ctx, valid, None, c, out, self.data_type)
        return out


def NullIf(a: Expression, b: Expression) -> Expression:
    from .base import Literal
    from .predicates import EqualTo
    return If(EqualTo(a, b).coerce(), Literal(None, a.data_type), a).coerce()


def Nvl(a: Expression, b: Expression) -> Expression:
    return Coalesce(a, b).coerce()
