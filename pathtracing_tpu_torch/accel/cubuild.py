"""Build and load the package's CUDA sources (csrc/*.cu).

`load(stem)` compiles csrc/<stem>.cu with nvcc for sm_90a into a shared
library with a plain C interface, at first use, into the package's
`_build/` directory (cached by a hash of the source, the shared header and
the flags) and returns it as a ctypes library.  `build_all` starts one
nvcc per build at the same time; `load(stem, defines)` builds the same
source with -D flags (the A/B tools' variants).  Everything is built with --fmad=false:
FMA contraction would change Moller-Trumbore's rounding and flip edge hits
against the plain PyTorch versions.

`host_library(stem)` compiles the same source as plain C++ with g++ (no
FMA contraction), so a kernel's traversal logic can be checked where
there is no GPU and no nvcc.  A traversal source ends in an `extern "C"
int <stem>_launch(...)` whose body launches through the `<STEM>_MODES`
X-macro; the host build swaps a `<<<...>>>` launch for a loop over the
rays (one loop iteration per CUDA thread).  A source that launches
through group_walk.cuh's `launch_groups` (trace2.cu) gets that header's
host branch instead: each ray's W lanes run as W std::threads meeting at
a C++20 std::barrier in every group primitive.  A source whose device
code is guarded by `#ifdef __CUDACC__` (leaf.cu, sampler.cu) provides its
own host entry in the `#else` branch.

`host_library`'s `defines` ({name: value}) are passed as -D flags, e.g.
TRACE2_LANES (lanes per ray of trace2.cu's group walk); each set of
defines is a library of its own.
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

from ..utils.profile import set_count

_CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]
_locks: dict = {}
_libs: dict = {}
_guard = threading.Lock()
BUILD_LOG: dict = {}    # stem -> nvcc's output of its build (registers, spills)


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


_INCLUDE = re.compile(r'#include "([\w.]+)"\n')


def _inlined(path: Path) -> str:
    """The text of a source with its `#include "..."` headers (from
    csrc/) inlined, each once, `#pragma once` dropped."""
    seen = set()

    def text(p):
        def sub(m):
            if m.group(1) in seen:
                return ""
            seen.add(m.group(1))
            return text(_CSRC_DIR / m.group(1))
        return _INCLUDE.sub(sub, p.read_text().replace("#pragma once", ""))
    return text(path)


def _dflags(defines) -> list:
    return [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]


def key(stem: str, defines=None) -> str:
    """The name of a build: the stem, then its defines."""
    return stem + "".join(f"_{k}{v}" for k, v in sorted(
        (defines or {}).items()))


def load(stem: str, defines=None):
    """The ctypes library of csrc/<stem>.cu, compiled if not built yet;
    `defines` ({name: value}, passed as -D flags) make another build of
    the same source, named key(stem, defines) in BUILD_LOG and in the host
    counter "kernels.<name>_s" of its build and load seconds
    (utils/profile.py; the A/B tools build their variants so)."""
    name = key(stem, defines)
    with _guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        t0 = time.perf_counter()
        src = source(stem)
        flags = _NVCC_FLAGS + _dflags(defines)
        tag = hashlib.sha256(_inlined(src).encode()
                             + " ".join(flags).encode()).hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = _BUILD_DIR / f"{name}_{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                                 capture_output=True, text=True)
            BUILD_LOG[name] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} {defines or ''}"
                                   ":\n" + BUILD_LOG[name])
            tmp.replace(so)
        _libs[name] = ctypes.CDLL(str(so))
        set_count(f"kernels.{name}_s", time.perf_counter() - t0)
        return _libs[name]


def build_all(builds=("trace2", "trace1", "leaf", "sampler", "sortkey")
              ) -> float:
    """Build (if needed) and load every source, one nvcc each, all started
    together.  A build is a stem or a (stem, defines) pair.  Returns the
    seconds spent."""
    t0 = time.perf_counter()
    errors = []

    def one(b):
        try:
            load(*((b,) if isinstance(b, str) else b))
        except Exception as e:      # re-raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(b,)) for b in builds]
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
        m = re.search(r"(trace[12]_kernel|trace2_window_kernel)ILi(\d)ELb"
                      r"(\d)ELb(\d)E(Li(\d+)E)?", line)
        if m:
            lanes = f" W={m.group(6)}" if m.group(6) else ""
            return (f"{m.group(1)} AMASK={m.group(2)} INST={m.group(3)} "
                    f"MOTION={m.group(4)}{lanes}")
        m = re.search(r"(leaf_scalar_kernel|leaf_mxu_kernel)ILi(\d)E"
                      r"(Li(\d+)E)?", line)
        if m:
            mode = ("vpu", "mxu_hi", "mxu_3x", "mxu_1x", "vpu_rec",
                    "vpu_cond", "vpu_dma", "vpu_while")[int(m.group(2))]
            lanes = f" W={m.group(4)}" if m.group(4) else ""
            return f"{m.group(1)} {mode}{lanes}"
        return line.strip()

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
#define __launch_bounds__(...)
#define __restrict__
struct dim3_ { int x; };
static thread_local dim3_ blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline float4 __ldg(const float4* p) { return *p; }
inline int4 __ldg(const int4* p) { return *p; }
inline float __ldg(const float* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
"""


def host_library(stem: str, out_dir, defines=None) -> ctypes.CDLL:
    """csrc/<stem>.cu (its headers inlined) compiled by g++ into out_dir;
    `<stem>_launch` then runs the kernel body on the CPU: once per ray on
    the calling thread, or, through launch_groups, W lanes per ray on W
    threads."""
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found")
    src = _inlined(source(stem)).replace("#include <cuda_runtime.h>", "")
    # kernel<...><<<grid, block, 0, stream>>>(args) -> a loop over the rays
    src, n_sub = re.subn(
        r"(\w+_kernel<AMASK, INST, MOTION>)[\s\\]*<<<[^>]*>>>\(([^;]*?)\);",
        r"for (int i_ = 0; i_ < n; ++i_) { blockIdx.x = i_; \1(\2); }",
        src, flags=re.S)
    if n_sub != 1 and "#ifdef __CUDACC__" not in src:
        raise RuntimeError(f"{stem}.cu: launch site not found")
    out_dir = Path(out_dir)
    name = key(stem, defines)
    cpp = out_dir / f"{name}_host.cpp"
    cpp.write_text(_HOST_SHIM + "static void host_init_() { blockDim.x = 1; "
                   "threadIdx.x = 0; }\n" + src.replace(
                       "if (n <= 0) return 0;",
                       "if (n <= 0) return 0;\n  host_init_();", 1))
    so = out_dir / f"{name}_host.so"
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                          "-pthread", "-shared", "-fPIC", *_dflags(defines),
                          "-o", str(so), str(cpp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {stem}.cu as host code:\n"
                           + res.stderr)
    return ctypes.CDLL(str(so))
