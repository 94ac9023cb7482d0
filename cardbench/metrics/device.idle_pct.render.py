"""The device's idle share of the traced slice: 100 x (1 - the union of
kernel and copy intervals / the span from the first call's start to the
last call's end)."""

from cardbench.core.readers import idle_pct as read  # noqa: F401
