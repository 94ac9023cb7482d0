"""Device kernel launches a render call, the port's and torch's alike,
over the calls of the traced slice."""

from cardbench.core.readers import launches_per_unit as read  # noqa: F401
