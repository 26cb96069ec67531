"""ctypes bindings for the native host runtime (native/src/preprocess.cc).

The port's own binding of the repository's C++ host library, the
counterpart of better_fastlio2_tpu/io/native.py.  The library is built
with g++ at first use (never at import) into `build/native/` at the
repository root, with the reference loader's flags.  It is never built
into `native/libbflio2_native.so`: that file is the JAX package's, which
its loader relinks and dlopens, and two loaders relinking one inode would
hand each other stale or corrupted mappings.  Where the library cannot
be built every entry point takes the numpy path of io/preprocess.py
(the same behavior, a slower host path); `available()` says which ran.

`pack_quant_bulk.calls` counts the rows the C++ packer wrote (0 when the
numpy formula packed them).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "decode_xyzi", "decode_livox", "decode_nclt",
           "write_pcd_xyzi", "voxel_downsample_host", "pack_quant_bulk",
           "LIB_PATH"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "src", "preprocess.cc")
LIB_PATH = os.path.join(_REPO, "build", "native", "libbflio2_native.so")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    """Link into a temp file of this process and rename it over the
    library: never truncate a .so that another process (or a handle this
    process dlopened earlier) has mapped."""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _is_stale() -> bool:
    """Missing, older than its source, or without the v2 wire symbol
    (read from the raw bytes before dlopen: loading first and rebuilding
    after would hand back the stale inode-deduped handle)."""
    try:
        if os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC):
            return True
        with open(LIB_PATH, "rb") as f:
            return b"pack_quant2" not in f.read()
    except OSError:
        return True


def _bind(lib) -> None:
    c_i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32)
    f64p = np.ctypeslib.ndpointer(np.float64)
    lib.decode_xyzi.restype = c_i64
    lib.decode_xyzi.argtypes = [
        f32p, c_i64, ctypes.c_int, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, f32p, f64p, f32p]
    lib.decode_livox.restype = c_i64
    lib.decode_livox.argtypes = [
        f32p, ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64), c_i64, ctypes.c_double,
        ctypes.c_int, f32p, f64p, f32p]
    lib.decode_nclt.restype = c_i64
    lib.decode_nclt.argtypes = [
        np.ctypeslib.ndpointer(np.uint8), c_i64, f32p, f32p]
    lib.write_pcd_xyzi.restype = ctypes.c_int
    lib.write_pcd_xyzi.argtypes = [ctypes.c_char_p, f32p, ctypes.c_void_p,
                                   c_i64]
    lib.voxel_downsample.restype = c_i64
    lib.voxel_downsample.argtypes = [
        f32p, c_i64, ctypes.c_double, np.ctypeslib.ndpointer(np.int64),
        f64p, c_i64, f32p]
    lib.pack_quant2.restype = None
    lib.pack_quant2.argtypes = [
        f32p, f32p, c_i64, ctypes.c_double, ctypes.c_double,
        np.ctypeslib.ndpointer(np.uint16)]


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.path.exists(_SRC) and _is_stale():
            _build()
        if os.path.exists(LIB_PATH) and not _is_stale():
            lib = ctypes.CDLL(LIB_PATH)
            _bind(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ library is built and loaded (else numpy paths)."""
    return _load() is not None


def decode_xyzi(xyzi: np.ndarray, t_in: np.ndarray | None = None,
                time_scale: float = 1.0, scan_period: float = 0.1,
                blind: float = 0.01, point_filter_num: int = 1):
    """Velodyne/Ouster-style decode of (n, 3+) f32 rows."""
    lib = _load()
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    n, stride = xyzi.shape
    if lib is None:
        from .preprocess import preprocess_velodyne

        return preprocess_velodyne(
            xyzi[:, :3], xyzi[:, 3] if stride > 3 else None,
            t_in, 0 if time_scale == 1.0 else 2,
            1.0 / scan_period, blind, point_filter_num)
    pts = np.empty((n, 3), np.float32)
    t = np.empty(n, np.float64)
    inten = np.empty(n, np.float32)
    t_ptr = (np.ascontiguousarray(t_in, np.float64).ctypes.data_as(
        ctypes.c_void_p) if t_in is not None else None)
    m = lib.decode_xyzi(xyzi, n, stride, t_ptr, time_scale, scan_period,
                        blind, point_filter_num, pts, t, inten)
    return pts[:m], t[:m], inten[:m]


def decode_livox(xyz, inten, tag, offset_ns, blind=0.01,
                 point_filter_num=1):
    """Livox custom-message decode (return-type gate, ns offsets)."""
    lib = _load()
    if lib is None:
        from .preprocess import preprocess_livox

        return preprocess_livox(xyz, inten, tag, offset_ns, blind,
                                point_filter_num)
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    pts = np.empty((n, 3), np.float32)
    t = np.empty(n, np.float64)
    out_i = np.empty(n, np.float32)
    inten_ptr = (np.ascontiguousarray(inten, np.float32).ctypes.data_as(
        ctypes.c_void_p) if inten is not None else None)
    m = lib.decode_livox(
        xyz, inten_ptr, np.ascontiguousarray(tag, np.uint8),
        np.ascontiguousarray(offset_ns, np.int64), n, blind,
        point_filter_num, pts, t, out_i)
    return pts[:m], t[:m], out_i[:m]


def decode_nclt(raw: bytes | np.ndarray):
    """NCLT's 8-byte point records -> (xyz (N, 3) f32, intensity)."""
    lib = _load()
    raw = np.frombuffer(raw, np.uint8) if isinstance(raw, bytes) else raw
    raw = np.ascontiguousarray(raw, np.uint8)
    if lib is None:
        from .nclt import decode_nclt_records

        return decode_nclt_records(raw)
    n = len(raw) // 8
    pts = np.empty((n, 3), np.float32)
    inten = np.empty(n, np.float32)
    m = lib.decode_nclt(raw, len(raw), pts, inten)
    return pts[:m], inten[:m]


def write_pcd_xyzi(path: str, xyz: np.ndarray,
                   inten: np.ndarray | None = None) -> None:
    """Binary x y z intensity PCD."""
    lib = _load()
    if lib is None:
        from .pcd import write_pcd

        write_pcd(path, xyz, inten)
        return
    xyz = np.ascontiguousarray(xyz, np.float32)
    ptr = (np.ascontiguousarray(inten, np.float32).ctypes.data_as(
        ctypes.c_void_p) if inten is not None else None)
    rc = lib.write_pcd_xyzi(path.encode(), xyz, ptr, len(xyz))
    if rc != 0:
        raise IOError(f"write_pcd_xyzi failed rc={rc}")


def voxel_downsample_host(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Host-side centroid downsample."""
    lib = _load()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        keys = np.floor(pts / voxel).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        acc = np.zeros((len(uniq), 3))
        np.add.at(acc, inv.reshape(-1), pts)
        cnt = np.bincount(inv.reshape(-1))
        return (acc / cnt[:, None]).astype(np.float32)
    cap = 1
    while cap < 2 * len(pts):
        cap <<= 1
    tk = np.empty(cap, np.int64)
    ta = np.empty(cap * 4, np.float64)
    out = np.empty((cap, 3), np.float32)
    m = lib.voxel_downsample(pts, len(pts), voxel, tk, ta, cap, out)
    return out[:m]


def pack_quant_bulk(pts: np.ndarray, t: np.ndarray, pos_scale: float,
                    dur: float) -> np.ndarray | None:
    """The C++ bulk-row packer of the quantized wire format (int16 point
    steps, uint8 time pairs; pipeline/lio.py:_pack_quant), or None
    without the library (the caller then packs with numpy).  The C++
    packer scales in double and numpy's formula in float32, so a value
    within a rounding of a half step lands one step apart in the two."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    t = np.ascontiguousarray(t, np.float32)
    n_raw = len(t)
    bulk = np.empty(3 * n_raw + n_raw // 2, np.uint16)
    lib.pack_quant2(pts, t, n_raw, float(pos_scale), float(dur), bulk)
    pack_quant_bulk.calls += 1
    return bulk


pack_quant_bulk.calls = 0
