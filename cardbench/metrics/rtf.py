"""The real-time factor: audio seconds rendered over the wall seconds of
the whole window, all calls and host gaps, closed at one synchronise.
Reads every ``rtf.<config>`` metric."""

from cardbench.core.readers import rtf as read  # noqa: F401
