"""Columnar UDFs — user-supplied batch functions as expressions; the port of
``spark_rapids_tpu/udf/columnar.py``.

The reference lets users accelerate their own UDFs by implementing
``RapidsUDF.evaluateColumnar(ColumnVector...)`` (sql-plugin
RapidsUDF.java:22-39). Here the user writes a batch function over value
arrays: on the device it receives torch tensors and may launch its own
kernel (udf/examples.py ``pallas_axpy``); on the host engine it receives
numpy arrays, or a separate ``host_fn`` runs instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from ..columnar import dtypes as dt
from ..expr.base import EvalCol, EvalContext, Expression

__all__ = ["ColumnarUDF", "columnar_udf"]


@dataclasses.dataclass(repr=False)
class ColumnarUDF(Expression):
    """fn maps value arrays -> value array; an output row is null when any
    input row is null (Spark UDFs with primitive args)."""
    fn: Callable
    udf_name: str
    _dtype: dt.DataType
    arg_exprs: Sequence[Expression]
    host_fn: Optional[Callable] = None
    #: False marks the fn as host-only -> tagged off the device
    device_ok: bool = True

    def __post_init__(self):
        self.children = tuple(self.arg_exprs)

    @property
    def data_type(self) -> dt.DataType:
        return self._dtype

    @property
    def name(self) -> str:
        return self.udf_name

    def with_children(self, children):
        return ColumnarUDF(self.fn, self.udf_name, self._dtype,
                           tuple(children), self.host_fn, self.device_ok)

    def runs_kernel(self) -> bool:
        # a device function may launch its own kernel (pallas_axpy's axpy)
        return self.device_ok

    def eval(self, ctx: EvalContext) -> EvalCol:
        cols = [c.eval(ctx) for c in self.children]
        fn = self.fn if ctx.is_device or self.host_fn is None else self.host_fn
        values = fn(*[c.values for c in cols])
        validity = None
        for c in cols:
            if c.validity is not None:
                validity = c.validity if validity is None \
                    else ctx.xp.logical_and(validity, c.validity)
        return EvalCol(values, validity, self._dtype)

    def __repr__(self):
        return f"{self.udf_name}({', '.join(map(repr, self.children))})"


def columnar_udf(return_type: dt.DataType, name: Optional[str] = None,
                 host_fn: Optional[Callable] = None, device_ok: bool = True):
    """Decorator: turn an array function into a columnar UDF factory.

    >>> @columnar_udf(dt.DOUBLE)
    ... def fma(a, b, c):
    ...     return a * b + c
    >>> df.select(fma(col("x"), col("y"), col("z")))
    """
    def wrap(fn: Callable):
        udf_name = name or fn.__name__

        def build(*args):
            from ..expr.functions import Column, _to_expr
            exprs = tuple(_to_expr(a) for a in args)
            return Column(ColumnarUDF(fn, udf_name, return_type, exprs,
                                      host_fn, device_ok))
        build.__name__ = udf_name
        build.fn = fn
        build.return_type = return_type
        return build
    return wrap
