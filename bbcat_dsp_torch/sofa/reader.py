"""SOFA (AES69) impulse-response files: read, look up, write.

The counterpart of the JAX package's ``sofa/reader.py``.  A SOFA file is
a netCDF-4 (HDF5) or classic netCDF-3 container; both are read, the
SimpleFreeFieldHRIR surface the renderers need is exposed (``Data.IR [M,
R, N]``, ``Data.SamplingRate``, ``Data.Delay``, ``SourcePosition`` with a
nearest-direction lookup) and :meth:`SOFAFile.hrtf_matrix` gives the
``[C_in, R, N]`` IR matrix a ``BinauralRenderer`` takes.  The classic
branch needs only scipy.  The HDF5 branch and :func:`write_sofa` (which
writes HDF5 only, as the JAX package's does) import ``h5py`` when they
are called: where it is not installed they raise an ``ImportError`` that
says so, and a netCDF-3 file still reads.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SOFAFile", "write_sofa"]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "an HDF5 (netCDF-4) SOFA file needs the h5py package, which is "
            "not installed; a classic netCDF-3 SOFA file reads without it"
        ) from e
    return h5py


def _read_h5(path: str) -> dict:
    h5py = _h5py()
    out: dict = {"attrs": {}, "vars": {}}
    with h5py.File(path, "r") as f:
        for k, v in f.attrs.items():
            out["attrs"][k] = v.decode() if isinstance(v, bytes) else v

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out["vars"][name] = np.asarray(obj)

        f.visititems(visit)
    return out


def _read_nc3(path: str) -> dict:
    from scipy.io import netcdf_file

    out: dict = {"attrs": {}, "vars": {}}
    with netcdf_file(path, "r", mmap=False) as f:
        for k, v in f._attributes.items():
            out["attrs"][k] = v.decode() if isinstance(v, bytes) else v
        for name, var in f.variables.items():
            out["vars"][name] = np.asarray(var.data).copy()
    return out


class SOFAFile:
    """A loaded SOFA IR set, every array float64 on the host."""

    def __init__(self, raw: dict):
        self.attributes = dict(raw["attrs"])
        v = raw["vars"]
        if "Data.IR" not in v:
            raise ValueError("not a SOFA IR file: missing Data.IR")
        self.ir = np.asarray(v["Data.IR"], np.float64)            # [M, R, N]
        fs = np.asarray(v.get("Data.SamplingRate", 48000.0)).reshape(-1)
        self.fs = float(fs[0])
        self.delay = np.asarray(
            v.get("Data.Delay", np.zeros((1, self.ir.shape[1]))), np.float64)
        # [M, 3]: azimuth, elevation (degrees), distance
        self.source_positions = np.asarray(
            v.get("SourcePosition", np.zeros((self.ir.shape[0], 3))),
            np.float64)
        self.listener_position = np.asarray(
            v.get("ListenerPosition", np.zeros((1, 3))), np.float64)

    @classmethod
    def open(cls, path: str) -> "SOFAFile":
        """Open a netCDF-4 (HDF5) or classic netCDF-3 SOFA file."""
        with open(path, "rb") as fp:
            magic = fp.read(8)
        if magic.startswith(b"\x89HDF"):
            return cls(_read_h5(path))
        if magic.startswith(b"CDF"):
            return cls(_read_nc3(path))
        raise ValueError(f"{path}: neither HDF5 nor netCDF classic")

    @property
    def n_measurements(self) -> int:
        return self.ir.shape[0]

    @property
    def n_receivers(self) -> int:
        return self.ir.shape[1]

    @property
    def n_samples(self) -> int:
        return self.ir.shape[2]

    @property
    def convention(self) -> str:
        return str(self.attributes.get("SOFAConventions", ""))

    def nearest(self, azimuth: float, elevation: float = 0.0) -> int:
        """Index of the measurement nearest to ``(azimuth, elevation)`` in
        degrees, by great-circle distance."""
        az = np.radians(self.source_positions[:, 0])
        el = np.radians(self.source_positions[:, 1])
        a0, e0 = np.radians(azimuth), np.radians(elevation)
        cosd = (np.sin(el) * np.sin(e0)
                + np.cos(el) * np.cos(e0) * np.cos(az - a0))
        return int(np.argmax(cosd))

    def impulse_response(self, index: int) -> np.ndarray:
        """``[R, N]``: one measurement's IRs."""
        return self.ir[index]

    def hrtf_matrix(self, directions) -> np.ndarray:
        """``[C_in, R, N]``: one measurement per input channel, each given
        by its index or by an ``(azimuth, elevation)`` pair resolved with
        :meth:`nearest`."""
        rows = []
        for d in directions:
            idx = d if isinstance(d, (int, np.integer)) else self.nearest(*d)
            rows.append(self.ir[idx])
        return np.stack(rows)


def write_sofa(path: str, ir: np.ndarray, fs: float,
               source_positions: np.ndarray | None = None,
               convention: str = "SimpleFreeFieldHRIR") -> None:
    """Write a minimal SimpleFreeFieldHRIR netCDF-4 (HDF5) SOFA file."""
    h5py = _h5py()
    ir = np.asarray(ir, np.float64)
    M, R, _ = ir.shape
    if source_positions is None:
        source_positions = np.zeros((M, 3))
    with h5py.File(path, "w") as f:
        f.attrs["Conventions"] = "SOFA"
        f.attrs["SOFAConventions"] = convention
        f.attrs["SOFAConventionsVersion"] = "1.0"
        f.attrs["DataType"] = "FIR"
        f.create_dataset("Data.IR", data=ir)
        f.create_dataset("Data.SamplingRate", data=np.asarray([fs]))
        f.create_dataset("Data.Delay", data=np.zeros((1, R)))
        f.create_dataset("SourcePosition", data=np.asarray(source_positions))
        f.create_dataset("ListenerPosition", data=np.zeros((1, 3)))
