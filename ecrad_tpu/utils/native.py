"""ctypes bindings for the native runtime components (native/*.cc).

Two shared libraries, built by `make -C native` (or lazily here when a
compiler is available):
 - libecrhook.so: the Dr Hook-analogue profiler core (per-thread call
   stacks, wall/CPU self+total time, peak RSS, fatal-signal stack dump;
   reference drhook/drhook/drhook.c).
 - libfortread.so: big-endian Fortran sequential-unformatted reader (the
   native data-loader for data/RADRRTM / RADSRTM; reference
   ifsrrtm/rrtm_kgb*.F90 READ path).

Both are optional: every consumer has a pure-Python fallback.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
_NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def _build_if_possible(libname: str, source: str) -> Optional[str]:
    """The library built from native/<source>; (re)built when missing
    or older than its source. The libraries are never tracked."""
    path = os.path.join(_DATA_DIR, libname)
    src = os.path.join(_NATIVE_SRC, source)
    if not os.path.exists(src):
        return None
    if os.path.exists(path) and (os.path.getmtime(path)
                                 >= os.path.getmtime(src)):
        return path
    try:
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
               "-o", path, src]
        if "hook" in libname:
            cmd.append("-lpthread")
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return path
    except Exception:
        return None


_hook_lib = None
_hook_tried = False


def hook_lib() -> Optional[ctypes.CDLL]:
    global _hook_lib, _hook_tried
    if _hook_tried:
        return _hook_lib
    _hook_tried = True
    path = _build_if_possible("libecrhook.so", "ecrhook.cc")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.ecr_hook_enter.argtypes = [ctypes.c_char_p]
        lib.ecr_hook_exit.argtypes = [ctypes.c_char_p]
        lib.ecr_hook_report.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long), ctypes.c_int]
        lib.ecr_hook_report.restype = ctypes.c_int
        lib.ecr_hook_stack_depth.restype = ctypes.c_int
        _hook_lib = lib
    except OSError:
        _hook_lib = None
    return _hook_lib


_fort_lib = None
_fort_tried = False


def fort_lib() -> Optional[ctypes.CDLL]:
    global _fort_lib, _fort_tried
    if _fort_tried:
        return _fort_lib
    _fort_tried = True
    path = _build_if_possible("libfortread.so", "fortread.cc")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.fort_open.argtypes = [ctypes.c_char_p]
        lib.fort_open.restype = ctypes.c_void_p
        lib.fort_close.argtypes = [ctypes.c_void_p]
        lib.fort_next_record_bytes.argtypes = [ctypes.c_void_p]
        lib.fort_next_record_bytes.restype = ctypes.c_long
        lib.fort_read_f64.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_long]
        lib.fort_read_f64.restype = ctypes.c_long
        lib.fort_skip.argtypes = [ctypes.c_void_p]
        lib.fort_skip.restype = ctypes.c_int
        _fort_lib = lib
    except OSError:
        _fort_lib = None
    return _fort_lib


class FortranFile:
    """Sequential big-endian unformatted reader (native when available).

    Mirrors the record framing the reference relies on: each record is
    [4-byte BE length][payload][4-byte BE length]."""

    def __init__(self, path: str):
        self.path = path
        self._lib = fort_lib()
        self._handle = None
        self._fp = None
        if self._lib is not None:
            self._handle = self._lib.fort_open(path.encode())
            if not self._handle:
                self._lib = None
        if self._lib is None:
            self._fp = open(path, "rb")

    def read_f64(self):
        """Read the next record as a float64 numpy array."""
        import numpy as np
        if self._lib is not None:
            nbytes = self._lib.fort_next_record_bytes(self._handle)
            if nbytes < 0:
                raise EOFError(self.path)
            n = nbytes // 8
            out = np.empty(n, np.float64)
            got = self._lib.fort_read_f64(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
            if got != n:
                raise IOError(f"short record in {self.path}")
            return out
        import struct
        hdr = self._fp.read(4)
        if len(hdr) < 4:
            raise EOFError(self.path)
        nbytes = struct.unpack(">i", hdr)[0]
        payload = self._fp.read(nbytes)
        trailer = struct.unpack(">i", self._fp.read(4))[0]
        if trailer != nbytes:
            raise IOError(f"bad record framing in {self.path}")
        import numpy as np
        return np.frombuffer(payload, ">f8").astype(np.float64)

    def close(self):
        if self._lib is not None and self._handle:
            self._lib.fort_close(self._handle)
            self._handle = None
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
