from . import dtypes  # noqa: F401
from .dtypes import DataType, TypeSig  # noqa: F401
from .host import HostColumn, HostTable  # noqa: F401
from .device import (  # noqa: F401
    DeviceColumn, DeviceTable, bucket_rows, concat_device_tables,
    shrink_to_fit,
)
