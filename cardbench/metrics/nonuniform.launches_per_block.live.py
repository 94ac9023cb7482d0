"""Device kernel launches a live block, the port's and torch's alike,
over the blocks of the traced slice (whole super-blocks, so every tail
firing is in)."""

from cardbench.core.readers import launches_per_unit as read  # noqa: F401
