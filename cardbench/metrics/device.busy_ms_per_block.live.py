"""The union of device activity (kernels and copies) in the traced slice
over its blocks, ms a block."""

from cardbench.core.readers import busy_ms_per_unit as read  # noqa: F401
