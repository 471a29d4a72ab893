from .base import (  # noqa: F401
    Alias, AttributeReference, EvalCol, EvalContext, Expression, Literal,
    resolve_expression,
)
from .arithmetic import (  # noqa: F401
    Abs, Add, BinaryArithmetic, Divide, IntegralDivide, Multiply, Pmod,
    Remainder, Subtract, UnaryMinus, numeric_promote,
)
from .cast import Cast  # noqa: F401
from .predicates import (  # noqa: F401
    And, BinaryComparison, EqualNullSafe, EqualTo, GreaterThan,
    GreaterThanOrEqual, In, IsNaN, IsNotNull, IsNull, LessThan,
    LessThanOrEqual, Not, Or,
)
from .conditional import CaseWhen, Coalesce, If, NullIf, Nvl  # noqa: F401
from .aggregates import (  # noqa: F401
    AggregateFunction, Average, Count, CountStar, Max, Min, Sum,
)
from . import functions  # noqa: F401
