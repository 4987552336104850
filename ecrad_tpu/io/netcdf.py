"""Minimal NetCDF reader/writer without the netCDF4 package.

Classic NetCDF (CDF-1/2) files are handled by scipy.io; NetCDF4/HDF5 files
by h5py. This covers every data file shipped with the reference (all are
classic format) plus HDF5 outputs if requested.

Reference parity: utilities/easy_netcdf.F90 (the OO wrapper with flexible
variable lookup and implicit transposes). Unlike the Fortran, arrays are
returned in C order exactly as stored (dimensions as listed in the file).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _is_hdf5(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == b"\x89HDF\r\n\x1a\n"


def _h5py():
    """h5py, imported only for NetCDF4 (HDF5) files."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "NetCDF4 (HDF5) files need the h5py package, which is not "
            "installed; classic NetCDF3 files need only scipy") from e
    return h5py


class NetcdfFile:
    """Read-only NetCDF file with case-insensitive variable lookup."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._h5 = None
        self._sp = None
        if _is_hdf5(path):
            self._h5 = _h5py().File(path, "r")
        else:
            from scipy.io import netcdf_file
            self._sp = netcdf_file(path, "r", mmap=False)

    # -- introspection -----------------------------------------------------
    def variables(self) -> List[str]:
        if self._h5 is not None:
            return list(self._h5.keys())
        return list(self._sp.variables.keys())

    def exists(self, name: str) -> bool:
        return self._resolve(name) is not None

    def _resolve(self, name: str) -> Optional[str]:
        names = self.variables()
        if name in names:
            return name
        lower = name.lower()
        for n in names:
            if n.lower() == lower:
                return n
        return None

    def dimensions(self) -> Dict[str, int]:
        if self._h5 is not None:
            dims = {}
            for k, v in self._h5.items():
                if hasattr(v, "shape"):
                    for i, s in enumerate(v.shape):
                        dims[f"{k}_{i}"] = s
            return dims
        return {k: (v if v is not None else -1)
                for k, v in self._sp.dimensions.items()}

    def dim(self, name: str) -> int:
        if self._sp is not None:
            d = self._sp.dimensions.get(name)
            if d is None:
                # unlimited dim: find from a variable
                for v in self._sp.variables.values():
                    if name in v.dimensions:
                        return v.shape[list(v.dimensions).index(name)]
            return d
        raise KeyError(name)

    # -- reading -----------------------------------------------------------
    def read(self, name: str, default=None) -> np.ndarray:
        """Read a variable as float64 ndarray (ints stay int)."""
        resolved = self._resolve(name)
        if resolved is None:
            if default is not None:
                return default
            raise KeyError(f"variable '{name}' not in {self.path}")
        if self._h5 is not None:
            data = np.asarray(self._h5[resolved])
        else:
            var = self._sp.variables[resolved]
            data = np.asarray(var[...]).copy()
            scale = getattr(var, "scale_factor", None)
            offset = getattr(var, "add_offset", None)
            if scale is not None or offset is not None:
                data = data * (scale if scale is not None else 1.0) + (
                    offset if offset is not None else 0.0)
        if data.dtype.kind == "f":
            data = data.astype(np.float64)
        return data

    def read_any(self, names: Sequence[str], default=None) -> Tuple[
            Optional[np.ndarray], Optional[str]]:
        """Try several variable names, return (data, found_name)."""
        for n in names:
            if self.exists(n):
                return self.read(n), n
        return default, None

    def attr(self, varname: str, attrname: str, default=None):
        resolved = self._resolve(varname)
        if resolved is None:
            return default
        if self._h5 is not None:
            val = self._h5[resolved].attrs.get(attrname, default)
        else:
            val = getattr(self._sp.variables[resolved], attrname, default)
        if isinstance(val, bytes):
            val = val.decode()
        return val

    def global_attr(self, attrname: str, default=None):
        if self._h5 is not None:
            return self._h5.attrs.get(attrname, default)
        val = getattr(self._sp, attrname, default)
        if isinstance(val, bytes):
            val = val.decode()
        return val

    def close(self):
        if self._h5 is not None:
            self._h5.close()
        if self._sp is not None:
            self._sp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_netcdf(path: str, dims: Dict[str, int],
                 variables: Dict[str, Tuple[Tuple[str, ...], np.ndarray]],
                 attrs: Optional[Dict[str, Dict[str, str]]] = None,
                 global_attrs: Optional[Dict[str, str]] = None,
                 hdf5: bool = False, deflate_level: int = 2,
                 shuffle: bool = True,
                 double_precision: bool = False) -> None:
    """Write a classic NetCDF3 (64-bit offset) file via scipy, or — with
    hdf5=True — a NetCDF4-compatible HDF5 file with deflate compression.

    variables: name -> (dim_names, array). attrs: name -> {attr: value}.

    Reference parity: utilities/easy_netcdf.F90 create_netcdf_file
    (NF90_HDF5 mode, :193-230) with per-variable deflate_level +
    shuffle (:22, define_variable), and the double_precision toggle
    (:281-292); selected by the driver's do_write_hdf5 namelist flag
    (driver/ecrad_driver_config.F90:92).
    """
    if hdf5:
        return _write_hdf5(path, dims, variables, attrs, global_attrs,
                           deflate_level, shuffle, double_precision)
    from scipy.io import netcdf_file
    attrs = attrs or {}
    with netcdf_file(path, "w", version=2) as f:
        for dname, dlen in dims.items():
            f.createDimension(dname, dlen)
        for vname, (vdims, data) in variables.items():
            data = np.asarray(data)
            if data.dtype == np.float64 and not double_precision:
                data = data.astype(np.float32)
            typecode = {np.dtype(np.float32): "f",
                        np.dtype(np.float64): "d",
                        np.dtype(np.int32): "i",
                        np.dtype(np.int64): "i"}.get(data.dtype, "f")
            if data.dtype == np.int64:
                data = data.astype(np.int32)
            var = f.createVariable(vname, typecode, vdims)
            var[...] = data
            for aname, aval in attrs.get(vname, {}).items():
                setattr(var, aname, aval)
        for aname, aval in (global_attrs or {}).items():
            setattr(f, aname, aval)


def _write_hdf5(path, dims, variables, attrs, global_attrs,
                deflate_level, shuffle, double_precision):
    """NetCDF4-compatible HDF5 writer (h5py): dimension-scale datasets
    attached to every variable axis, gzip deflate + byte shuffle.
    Readable by netCDF4/xarray and by our own NetcdfFile reader."""
    h5py = _h5py()
    attrs = attrs or {}
    comp = dict(compression="gzip",
                compression_opts=int(max(0, min(9, deflate_level))),
                shuffle=bool(shuffle)) if deflate_level > 0 else {}
    with h5py.File(path, "w") as f:
        scales = {}
        for i, (dname, dlen) in enumerate(dims.items()):
            # phony dimension-scale dataset (what netCDF4 writes for a
            # dimension without a coordinate variable of the same name)
            if dname in variables:
                continue
            d = f.create_dataset(dname, shape=(dlen,), dtype="f4")
            d.make_scale(dname)
            d.attrs["_Netcdf4Dimid"] = np.int32(i)
            scales[dname] = d
        for vname, (vdims, data) in variables.items():
            data = np.asarray(data)
            if data.dtype.kind == "f":
                data = data.astype(
                    np.float64 if double_precision else np.float32)
            elif data.dtype == np.int64:
                data = data.astype(np.int32)
            kw = dict(comp) if data.ndim > 0 else {}
            v = f.create_dataset(vname, data=data, **kw)
            if vname in dims:            # coordinate variable
                v.make_scale(vname)
                scales[vname] = v
            for aname, aval in attrs.get(vname, {}).items():
                v.attrs[aname] = aval
        for vname, (vdims, _) in variables.items():
            v = f[vname]
            if vname in scales:
                continue
            for ax, dname in enumerate(vdims):
                if dname in scales:
                    v.dims[ax].attach_scale(scales[dname])
        for aname, aval in (global_attrs or {}).items():
            f.attrs[aname] = aval
