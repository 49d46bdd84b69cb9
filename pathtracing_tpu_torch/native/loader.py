"""ctypes loaders for the native C++ helpers: the SAH BVH builder
(bvh_builder.cpp), the C library's float32 sin/cos/atan2 over arrays
(libm_vec.cpp) and the Wavefront OBJ geometry parser (obj_parser.cpp).

Each source compiles with g++ on first use into
`pathtracing_tpu_torch/_build/<name>_<hash>.so` (a plain C ABI loaded with
ctypes; the name is keyed by the source's content hash, so a rebuild
happens only when the source changes).  Callers
fall back to NumPy / PyTorch code when no toolchain is available.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
_lock = threading.Lock()
_libs = {}


def _compile(name: str, flags: list) -> Path | None:
    src = _HERE / f"{name}.cpp"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"{name}_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, "-shared", "-fPIC", str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        tmp.replace(out)            # atomic: parallel test workers race here
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    return out


def _load(name: str, flags: list, declare):
    """The compiled library `name` (None without a toolchain), loaded
    once per process and declared by `declare(lib)`."""
    with _lock:
        if name not in _libs:
            so = _compile(name, flags)
            lib = ctypes.CDLL(str(so)) if so is not None else None
            if lib is not None:
                declare(lib)
            _libs[name] = lib
        return _libs[name]


def _declare_bvh(lib):
    lib.build_bvh_native.restype = ctypes.c_int
    lib.build_bvh_native.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]


def _get_lib():
    return _load("bvh_builder", ["-O3", "-march=native", "-std=c++20",
                                 "-pthread"], _declare_bvh)


def _declare_libm(lib):
    P = ctypes.c_void_p
    for fn in ("sinf_v", "cosf_v"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [P, P, ctypes.c_int64]
    lib.atan2f_v.restype = None
    lib.atan2f_v.argtypes = [P, P, P, ctypes.c_int64]


def libm_vec():
    """The C library's float32 sinf_v / cosf_v / atan2f_v over arrays, or
    None without a toolchain."""
    return _load("libm_vec", ["-O2", "-std=c++17"], _declare_libm)


def native_available() -> bool:
    return _get_lib() is not None


def native_build_bvh(lo: np.ndarray, hi: np.ndarray, leaf_max: int):
    """Run the C++ builder.  Returns (wide_lo, wide_hi, wide_child, order,
    max_depth) or None if the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    W = 8
    n = len(lo)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    max_nodes = n + 2
    order = np.empty(n, np.int64)
    wlo = np.empty((max_nodes, W, 3), np.float32)
    whi = np.empty((max_nodes, W, 3), np.float32)
    wchild = np.empty((max_nodes, W), np.int32)
    counts = np.zeros(2, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.build_bvh_native(
        p(lo, ctypes.c_float), p(hi, ctypes.c_float),
        ctypes.c_int64(n), ctypes.c_int32(leaf_max),
        ctypes.c_int64(max_nodes),
        p(order, ctypes.c_int64), p(wlo, ctypes.c_float),
        p(whi, ctypes.c_float), p(wchild, ctypes.c_int32),
        p(counts, ctypes.c_int64))
    if rc != 0:
        return None
    nn = int(counts[0])
    return (wlo[:nn].copy(), whi[:nn].copy(), wchild[:nn].copy(),
            order, int(counts[1]))


def _declare_obj(lib):
    lib.obj_open.restype = ctypes.c_void_p
    lib.obj_open.argtypes = [ctypes.c_char_p]
    lib.obj_counts.restype = None
    lib.obj_counts.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_int64)] * 8
    lib.obj_fill.restype = None
    lib.obj_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_char_p]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]


def _get_obj_lib():
    return _load("obj_parser", ["-O3", "-march=native", "-std=c++20"],
                 _declare_obj)


def native_parse_obj(path):
    """Parse OBJ geometry with the C++ parser.  Returns dict(v [V,3] f32,
    vn [N,3] f32, vt [T,2] f32, tri [F,3,3] i64 (vi, ti, ni; -1 absent),
    tri_mat [F] i32 (usemtl index, -1 none), usemtl [list[str]],
    mtllib [list[str]]), or None without a toolchain or when the file
    cannot be read."""
    lib = _get_obj_lib()
    if lib is None:
        return None
    h = lib.obj_open(str(path).encode())
    if not h:
        return None
    try:
        c = [ctypes.c_int64(0) for _ in range(8)]
        lib.obj_counts(h, *[ctypes.byref(x) for x in c])
        nv, nvn, nvt, ntri, _, use_b, _, lib_b = [int(x.value) for x in c]
        v = np.empty((nv, 3), np.float32)
        vn = np.empty((nvn, 3), np.float32)
        vt = np.empty((nvt, 2), np.float32)
        tri = np.empty((ntri, 3, 3), np.int64)
        tri_mat = np.empty((ntri,), np.int32)
        use_blob = ctypes.create_string_buffer(max(use_b, 1))
        lib_blob = ctypes.create_string_buffer(max(lib_b, 1))

        def p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.obj_fill(h, p(v, ctypes.c_float), p(vn, ctypes.c_float),
                     p(vt, ctypes.c_float), p(tri, ctypes.c_int64),
                     p(tri_mat, ctypes.c_int32), use_blob, lib_blob)

        def names(blob, n):
            return (blob.raw[:n].decode(errors="replace").split("\0")[:-1]
                    if n else [])

        return dict(v=v, vn=vn, vt=vt, tri=tri, tri_mat=tri_mat,
                    usemtl=names(use_blob, use_b),
                    mtllib=names(lib_blob, lib_b))
    finally:
        lib.obj_free(h)
