"""Library registration: the versions of what this process loaded.

The counterpart of the JAX package's ``register.py``: an idempotent
:func:`register` that records this package's version and its
dependencies' in a registry for the whole process, and
:func:`loaded_versions` to read it.  Where the JAX package records
``jax``, this one records ``torch`` and the CUDA version PyTorch was built
for (``"none"`` for a CPU-only build).
"""

from __future__ import annotations

import threading

__all__ = ["register", "loaded_versions"]

_lock = threading.Lock()
_versions: dict[str, str] = {}


def loaded_versions() -> dict[str, str]:
    """A copy of the registry."""
    with _lock:
        return dict(_versions)


def register() -> bool:
    """Record this package's, PyTorch's, CUDA's and numpy's versions once;
    returns True, as the reference's does."""
    with _lock:
        if _versions:
            return True
        import numpy
        import torch

        from . import __version__

        _versions.update({"bbcat_dsp_torch": __version__,
                          "torch": torch.__version__,
                          "cuda": torch.version.cuda or "none",
                          "numpy": numpy.__version__})
        return True
