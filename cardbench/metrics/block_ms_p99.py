"""The live latency: the 99th percentile (numpy's linear) over every
block of the window, due time to output in host memory, in ms.  Reads
every ``block_ms_p99.<config>`` metric."""

from cardbench.core.readers import p99_ms as read  # noqa: F401
