"""Build and load the package's CUDA sources (csrc/*.cu).

`load(stem)` compiles csrc/<stem>.cu with nvcc for sm_90a into a shared
library with a plain C interface, at first use, into the package's
`_build/` directory (cached by a hash of the source, the shared header and
the flags) and returns it as a ctypes library.  `build_all` starts one
nvcc per source at the same time.  Everything is built with --fmad=false:
FMA contraction would change Moller-Trumbore's rounding and flip edge hits
against the plain PyTorch versions.

`host_library(stem)` compiles the same source as plain C++ with g++ (one
loop iteration per CUDA thread, no FMA contraction), so a kernel's
traversal logic can be checked where there is no GPU and no nvcc.  A
traversal source ends in an `extern "C" int <stem>_launch(...)` whose
body launches through the `<STEM>_MODES` X-macro; the host build swaps
the `<<<...>>>` launch for a loop over the rays.  A source whose device
code is guarded by `#ifdef __CUDACC__` (leaf.cu) provides its own host
entry in the `#else` branch instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_HEADER = _CSRC_DIR / "trace_common.cuh"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]
_locks: dict = {}
_libs: dict = {}
_guard = threading.Lock()
BUILD_LOG: dict = {}    # stem -> nvcc's output of its build (registers, spills)
BUILD_SECONDS: dict = {}


def source(stem: str) -> Path:
    return _CSRC_DIR / f"{stem}.cu"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def load(stem: str):
    """The ctypes library of csrc/<stem>.cu, compiled if not built yet."""
    with _guard:
        lock = _locks.setdefault(stem, threading.Lock())
    with lock:
        if stem in _libs:
            return _libs[stem]
        t0 = time.perf_counter()
        src = source(stem)
        tag = hashlib.sha256(src.read_bytes() + _HEADER.read_bytes()
                             + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = _BUILD_DIR / f"{stem}_{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                                  str(src)], capture_output=True, text=True)
            BUILD_LOG[stem] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   + BUILD_LOG[stem])
            tmp.replace(so)
        _libs[stem] = ctypes.CDLL(str(so))
        BUILD_SECONDS[stem] = time.perf_counter() - t0
        return _libs[stem]


def build_all(stems=("trace2", "trace1", "leaf")) -> float:
    """Build (if needed) and load every source, one nvcc each, all started
    together.  Returns the seconds spent."""
    t0 = time.perf_counter()
    errors = []

    def one(stem):
        try:
            load(stem)
        except Exception as e:      # re-raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(s,)) for s in stems]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def kernel_resources(stem: str) -> list:
    """(function, resource line) pairs of the last build's `-Xptxas -v`
    output, per template instance: the kernel's registers, and the stack
    frame and spills of the kernel and of each out-of-line device function
    (ptxas prints a "Used N registers" line per entry function and a
    "Function properties" block per function)."""
    def name_of(line):
        m = re.search(r"(trace[12]_kernel|leaf_kernel|window_walk)"
                      r"ILi(\d)ELb(\d)ELb(\d)E", line)
        return (f"{m.group(1)} AMASK={m.group(2)} INST={m.group(3)} "
                f"MOTION={m.group(4)}" if m else line.strip())

    out, entry, func = [], "?", "?"
    for line in BUILD_LOG.get(stem, "").splitlines():
        if "Compiling entry" in line:
            entry = func = name_of(line)
        elif "Function properties for" in line:
            func = name_of(line)
        elif "registers" in line:
            out.append((entry, line.strip()))
        elif "spill" in line:
            out.append((func, line.strip()))
    return out


# ---------------------------------------------------------------------------
# Host build (no GPU, no nvcc): the kernel's logic as plain C++
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __restrict__
struct dim3_ { int x; };
static dim3_ blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline float4 __ldg(const float4* p) { return *p; }
inline int4 __ldg(const int4* p) { return *p; }
inline float __ldg(const float* p) { return *p; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
"""


def host_library(stem: str, out_dir) -> ctypes.CDLL:
    """csrc/<stem>.cu (with trace_common.cuh inlined) compiled by g++ into
    out_dir; `<stem>_launch` then runs the kernel body once per ray on the
    calling thread."""
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found")
    header = _HEADER.read_text().replace("#pragma once", "")
    header = header.replace("#include <cuda_runtime.h>", "")
    src = source(stem).read_text().replace('#include "trace_common.cuh"',
                                           header)
    # kernel<...><<<grid, block, 0, stream>>>(args) -> a loop over the rays
    src, n_sub = re.subn(
        r"(\w+_kernel<AMASK, INST, MOTION>)[\s\\]*<<<[^>]*>>>\(([^;]*?)\);",
        r"for (int i_ = 0; i_ < n; ++i_) { blockIdx.x = i_; \1(\2); }",
        src, flags=re.S)
    if n_sub != 1 and "#ifdef __CUDACC__" not in src:
        raise RuntimeError(f"{stem}.cu: launch site not found")
    out_dir = Path(out_dir)
    cpp = out_dir / f"{stem}_host.cpp"
    cpp.write_text(_HOST_SHIM + "static void host_init_() { blockDim.x = 1; "
                   "threadIdx.x = 0; }\n" + src.replace(
                       "if (n <= 0) return 0;",
                       "if (n <= 0) return 0;\n  host_init_();", 1))
    so = out_dir / f"{stem}_host.so"
    res = subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared",
                          "-fPIC", "-o", str(so), str(cpp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {stem}.cu as host code:\n"
                           + res.stderr)
    return ctypes.CDLL(str(so))
