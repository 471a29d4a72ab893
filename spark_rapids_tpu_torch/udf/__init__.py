"""Columnar UDFs: user batch functions as expressions (udf/columnar.py),
the example UDFs (udf/examples.py) and their hand-written CUDA kernels
(udf/kernels.py)."""
from .columnar import ColumnarUDF, columnar_udf  # noqa: F401
