"""
Native host kernels — ctypes loader with on-demand compilation.

The shared library is built from router.cpp with g++ -O3 -fopenmp on first
use (cached in `.native_cache/` at the root of the checkout, or in
$PCR_NATIVE_CACHE); if no compiler is available, callers fall back to the
vectorized numpy paths (routing.py checks `available()`). Set PCR_NATIVE=0
to force the fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

__all__ = ["available", "lib", "assign", "assign_cells", "fractional_cells",
           "lzw_encode", "lzw_decode", "set_num_threads"]

_LIB = None
_TRIED = False


def _src_path() -> str:
    return os.path.join(os.path.dirname(__file__), "router.cpp")


def _build(src: str, out: str) -> bool:
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    for omp in (["-fopenmp"], []):
        try:
            subprocess.run(["g++", *flags, *omp, src, "-o", out],
                           check=True, capture_output=True, timeout=120)
            return True
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            continue
    return False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("PCR_NATIVE", "1") == "0":
        return None
    src = _src_path()
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get("PCR_NATIVE_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".native_cache")
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        return None
    out = os.path.join(cache, f"pcr_router_{digest}.so")
    if not os.path.exists(out):
        # build under a private name, then rename: concurrent processes
        # never load a half-written library
        tmp = f"{out}.{os.getpid()}.tmp"
        if not _build(src, tmp):
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None

    d = ctypes.POINTER(ctypes.c_double)
    f = ctypes.POINTER(ctypes.c_float)
    i = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.pcr_assign.argtypes = [d, d, ctypes.c_int64] + \
        [ctypes.c_double] * 8 + [ctypes.c_int32] * 2 + [i, i, u8]
    lib.pcr_assign_cells.argtypes = [d, d, ctypes.c_int64] + \
        [ctypes.c_double] * 8 + [ctypes.c_int32] * 3 + [i]
    lib.pcr_fractional_cells.argtypes = [d, d, ctypes.c_int64] + \
        [ctypes.c_double] * 4 + [i, i, f, f]
    lib.pcr_native_version.restype = ctypes.c_int
    lib.pcr_native_threads.restype = ctypes.c_int
    u8c = ctypes.POINTER(ctypes.c_uint8)
    lib.pcr_lzw_encode.argtypes = [u8c, ctypes.c_int64, u8c, ctypes.c_int64]
    lib.pcr_lzw_encode.restype = ctypes.c_int64
    lib.pcr_lzw_decode.argtypes = [u8c, ctypes.c_int64, u8c, ctypes.c_int64]
    lib.pcr_lzw_decode.restype = ctypes.c_int64
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.pcr_bucket_nsub.argtypes = [i, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32]
    lib.pcr_bucket_nsub.restype = ctypes.c_int64
    lib.pcr_bucket_layout.argtypes = [i, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int64, i64, i]
    lib.pcr_pack_point_wire.argtypes = [
        i, i, u8, f, f, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i]
    lib.pcr_line_runs_count.argtypes = [i, i, i, i, u8, ctypes.c_int64]
    lib.pcr_line_runs_count.restype = ctypes.c_int64
    lib.pcr_line_runs_emit.argtypes = [i, i, i, i, u8] + [i] * 4 + \
        [ctypes.c_int64] + [i] * 5
    lib.pcr_line_runs_emit.restype = ctypes.c_int64
    lib.pcr_fin_avg.argtypes = [f, f, f, ctypes.c_int64]
    lib.pcr_fin_sentinel.argtypes = [f, f, ctypes.c_int64, ctypes.c_float]
    lib.pcr_fin_count.argtypes = [f, f, ctypes.c_int64]
    lib.pcr_set_num_threads.argtypes = [ctypes.c_int]
    lib.pcr_set_num_threads.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def lib():
    return _load()


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def assign(cfg, x: np.ndarray, y: np.ndarray):
    """Native world→cell assignment. Returns (col, row, valid) identical to
    GridConfig.world_to_cell_array."""
    L = _load()
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    col = np.empty(n, np.int32)
    row = np.empty(n, np.int32)
    valid = np.empty(n, np.uint8)
    b = cfg.bounds
    L.pcr_assign(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double), n,
                 b.min_x, b.min_y, b.max_x, b.max_y,
                 cfg.origin_x, cfg.origin_y,
                 1.0 / cfg.cell_size_x, 1.0 / cfg.cell_size_y,
                 cfg.width, cfg.height,
                 _ptr(col, ctypes.c_int32), _ptr(row, ctypes.c_int32),
                 _ptr(valid, ctypes.c_uint8))
    return col, row, valid.astype(bool)


def assign_cells(cfg, x: np.ndarray, y: np.ndarray,
                 sentinel: int) -> np.ndarray:
    """Native fused assign+flatten with invalid→sentinel."""
    L = _load()
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    cells = np.empty(n, np.int32)
    b = cfg.bounds
    L.pcr_assign_cells(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double), n,
                       b.min_x, b.min_y, b.max_x, b.max_y,
                       cfg.origin_x, cfg.origin_y,
                       1.0 / cfg.cell_size_x, 1.0 / cfg.cell_size_y,
                       cfg.width, cfg.height, sentinel,
                       _ptr(cells, ctypes.c_int32))
    return cells


def fractional_cells(cfg, x: np.ndarray, y: np.ndarray):
    """Native fused fractional-cell computation: (icx, icy, sub_cx, sub_cy)."""
    L = _load()
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    icx = np.empty(n, np.int32)
    icy = np.empty(n, np.int32)
    sub_cx = np.empty(n, np.float32)
    sub_cy = np.empty(n, np.float32)
    L.pcr_fractional_cells(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                           n, cfg.origin_x, cfg.origin_y,
                           1.0 / cfg.cell_size_x, 1.0 / cfg.cell_size_y,
                           _ptr(icx, ctypes.c_int32),
                           _ptr(icy, ctypes.c_int32),
                           _ptr(sub_cx, ctypes.c_float),
                           _ptr(sub_cy, ctypes.c_float))
    return icx, icy, sub_cx, sub_cy


def pack_point_wire(col, row, valid, values, weights, start: int, end: int,
                    bucket: int, width: int, sentinel: int,
                    mode: int) -> np.ndarray:
    """One-pass staging pack for the grid-state Point layout.

    Returns the padded int32 device buffer [cells | f0 (| f1)] for the
    [start, end) slice; mode 0 = Sum/Average (f0=value), 1 = Count (f0=1),
    2 = WeightedAverage (f0=value*w, f1=w)."""
    L = _load()
    nseg = 3 if mode == 2 else 2
    out = np.empty(nseg * bucket, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    row = np.ascontiguousarray(row, np.int32)
    if valid.dtype == np.bool_:
        valid = valid.view(np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    values = np.ascontiguousarray(values, np.float32)
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32)
        wptr = _ptr(weights, ctypes.c_float)
    else:
        wptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    L.pcr_pack_point_wire(_ptr(col, ctypes.c_int32),
                          _ptr(row, ctypes.c_int32),
                          _ptr(valid, ctypes.c_uint8),
                          _ptr(values, ctypes.c_float), wptr,
                          start, end, bucket, width, sentinel, mode,
                          _ptr(out, ctypes.c_int32))
    return out


def set_num_threads(n: int) -> None:
    """Cap the OpenMP thread count used by every native kernel
    (PipelineConfig.cpu_threads; the reference does the same via
    omp_set_num_threads, pipeline.cpp:94-98). n <= 0 restores the
    runtime default. No-op when the native library is unavailable."""
    L = _load()
    if L is not None:
        L.pcr_set_num_threads(int(n))


def lzw_encode(data: bytes) -> bytes:
    """Native TIFF LZW encode (byte-compatible with io.geotiff.lzw_encode)."""
    L = _load()
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    # worst case ~12/8 expansion plus slack
    out = np.empty(n * 2 + 64, np.uint8)
    m = L.pcr_lzw_encode(_ptr(src, ctypes.c_uint8), n,
                         _ptr(out, ctypes.c_uint8), len(out))
    if m < 0:
        raise RuntimeError("native LZW encode overflow")
    return out[:m].tobytes()


def lzw_decode(data: bytes, max_out: int) -> bytes:
    """Native TIFF LZW decode; max_out bounds the decoded size."""
    L = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max_out, np.uint8)
    m = L.pcr_lzw_decode(_ptr(src, ctypes.c_uint8), len(src),
                         _ptr(out, ctypes.c_uint8), max_out)
    if m < 0:
        raise RuntimeError("native LZW decode failed")
    return out[:m].tobytes()


def bucket_layout(eb: np.ndarray, nblocks: int, block: int,
                  visit_all: bool, nsub_bucket_fn):
    """Native counting-sort layout for the separable Gaussian splat.

    Returns (slots int64 (E,), bids int32 (nsub,), nsub) with -1 slots as
    padding; trailing pads carry the last real block id."""
    L = _load()
    eb = np.ascontiguousarray(eb, np.int32)
    n = len(eb)
    nsub_real = L.pcr_bucket_nsub(_ptr(eb, ctypes.c_int32), n, nblocks,
                                  block, int(visit_all))
    nsub = nsub_bucket_fn(max(int(nsub_real), 1))
    E = nsub * block
    slots = np.empty(E, np.int64)
    bids = np.zeros(nsub, np.int32)
    L.pcr_bucket_layout(_ptr(eb, ctypes.c_int32), n, nblocks, block,
                        int(visit_all), nsub,
                        _ptr(slots, ctypes.c_int64),
                        _ptr(bids, ctypes.c_int32))
    return slots, bids, nsub


def line_runs(ix0, iy0, ix1, iy1, valid, clip_cs, clip_rs, clip_ce,
              clip_re):
    """Native closed-form Bresenham run expansion (clipped rectangles).

    Returns (ax, bx, ay, by, owner) int32 arrays."""
    L = _load()
    n = len(ix0)
    ix0 = np.ascontiguousarray(ix0, np.int32)
    iy0 = np.ascontiguousarray(iy0, np.int32)
    ix1 = np.ascontiguousarray(ix1, np.int32)
    iy1 = np.ascontiguousarray(iy1, np.int32)
    v = np.ascontiguousarray(valid, np.uint8)
    cs = np.ascontiguousarray(clip_cs, np.int32)
    rs = np.ascontiguousarray(clip_rs, np.int32)
    ce = np.ascontiguousarray(clip_ce, np.int32)
    re = np.ascontiguousarray(clip_re, np.int32)
    cap = int(L.pcr_line_runs_count(_ptr(ix0, ctypes.c_int32),
                                    _ptr(iy0, ctypes.c_int32),
                                    _ptr(ix1, ctypes.c_int32),
                                    _ptr(iy1, ctypes.c_int32),
                                    _ptr(v, ctypes.c_uint8), n))
    ax = np.empty(cap, np.int32)
    bx = np.empty(cap, np.int32)
    ay = np.empty(cap, np.int32)
    by = np.empty(cap, np.int32)
    owner = np.empty(cap, np.int32)
    m = int(L.pcr_line_runs_emit(
        _ptr(ix0, ctypes.c_int32), _ptr(iy0, ctypes.c_int32),
        _ptr(ix1, ctypes.c_int32), _ptr(iy1, ctypes.c_int32),
        _ptr(v, ctypes.c_uint8),
        _ptr(cs, ctypes.c_int32), _ptr(rs, ctypes.c_int32),
        _ptr(ce, ctypes.c_int32), _ptr(re, ctypes.c_int32), n,
        _ptr(ax, ctypes.c_int32), _ptr(bx, ctypes.c_int32),
        _ptr(ay, ctypes.c_int32), _ptr(by, ctypes.c_int32),
        _ptr(owner, ctypes.c_int32)))
    return ax[:m], bx[:m], ay[:m], by[:m], owner[:m]


def fin_avg(sum_arr: np.ndarray, cnt_arr: np.ndarray) -> np.ndarray:
    """Single-pass Average finalize: sum/count with empty-cell NaN."""
    L = _load()
    s = np.ascontiguousarray(sum_arr, np.float32)
    c = np.ascontiguousarray(cnt_arr, np.float32)
    out = np.empty_like(s)
    L.pcr_fin_avg(_ptr(s, ctypes.c_float), _ptr(c, ctypes.c_float),
                  _ptr(out, ctypes.c_float), s.size)
    return out


def fin_sentinel(state: np.ndarray, sentinel: float) -> np.ndarray:
    """Single-pass Max/Min finalize: sentinel (±FLT_MAX) -> NaN."""
    L = _load()
    s = np.ascontiguousarray(state, np.float32)
    out = np.empty_like(s)
    L.pcr_fin_sentinel(_ptr(s, ctypes.c_float), _ptr(out, ctypes.c_float),
                       s.size, ctypes.c_float(sentinel))
    return out


def fin_count(state: np.ndarray) -> np.ndarray:
    """Single-pass Count finalize: zero -> NaN."""
    L = _load()
    s = np.ascontiguousarray(state, np.float32)
    out = np.empty_like(s)
    L.pcr_fin_count(_ptr(s, ctypes.c_float), _ptr(out, ctypes.c_float),
                    s.size)
    return out
