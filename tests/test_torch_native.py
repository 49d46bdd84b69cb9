"""The JAX package's native SAH builder, made loadable before any port test
compares tables or renders with a JAX build.

The JAX loader (pathtracing_tpu/native/loader.py) has g++ write its
library straight to the final name and remembers a failed load for the
life of the process.  With several test workers starting on a tree
without the library, one worker can load another's half-written file,
fail, and build every later JAX scene with the NumPy SAH builder, whose
triangle order differs from the native one (and from the port's).  A
comparison against such a build fails for a reason that has nothing to
do with the port.

`jax_native_builder()` removes the race for the process that calls it:
it compiles the library under a temporary name and renames it into place
when it is missing, waits until the file at the final name is a complete
shared object that loads, clears a failed load the JAX loader remembered,
and asserts that both packages' native builders are available.  The
comparisons never run against a fallback build: without a toolchain they
fail here, loudly.  The port test modules that compare with JAX builds
call it from a module-scoped autouse fixture.
"""
import ctypes
import hashlib
import os
import struct
import subprocess
import time

WAIT_SECONDS = 120.0
POLL_SECONDS = 0.5


def jax_builder_path():
    """The file name the JAX loader gives its library (loader.py's
    `_compile`): `_bvh_builder_<sha256 of the source, 16 hex>.so`."""
    from pathtracing_tpu.native import loader as jl
    tag = hashlib.sha256(jl._SRC.read_bytes()).hexdigest()[:16]
    return jl._HERE / f"_bvh_builder_{tag}.so"


def _compile_atomic(so):
    """Compile the JAX builder with its loader's flags into a temporary
    file beside `so`, then rename it into place (atomic on one file
    system)."""
    from pathtracing_tpu.native import loader as jl
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++20",
                        "-shared", "-fPIC", "-pthread", str(jl._SRC), "-o",
                        str(tmp)], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _complete_elf(so):
    """True when `so` holds a whole ELF64 file: its section header table,
    which the linker writes last, lies inside the file."""
    try:
        data = so.read_bytes()
    except OSError:
        return False
    if len(data) < 64 or data[:4] != b"\x7fELF" or data[4] != 2:
        return False
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", data, 0x3A)
    return shoff > 0 and shoff + shentsize * shnum <= len(data)


def jax_native_builder():
    """Make the JAX package's native SAH builder loaded in this process
    (see the module docstring) and return its path."""
    from pathtracing_tpu.native import loader as jl
    from pathtracing_tpu_torch.native.loader import native_available
    so = jax_builder_path()
    if not so.exists():
        _compile_atomic(so)
    deadline = time.monotonic() + WAIT_SECONDS
    while True:
        # another process may still be writing the file (the JAX loader
        # writes in place): wait until it is whole and loads
        try:
            if _complete_elf(so):
                ctypes.CDLL(str(so))
                break
            err = "incomplete shared object"
        except OSError as e:
            err = str(e)
        if time.monotonic() > deadline:
            raise RuntimeError(f"the JAX SAH builder {so} did not become "
                               f"loadable within {WAIT_SECONDS:.0f} s: {err}")
        time.sleep(POLL_SECONDS)
    with jl._lock:
        if jl._lib is None:
            jl._tried = False       # forget a load that lost the race
    assert jl._get_lib() is not None, "the JAX native SAH builder is missing"
    assert native_available(), "the port's native SAH builder is missing"
    return so


def test_torch_jax_native_builder_loads_after_a_failed_load(tmp_path):
    """A process whose JAX loader remembered a failed load (the race's
    outcome) gets the finished library back, and a torn file is told
    apart from a whole one."""
    from pathtracing_tpu.native import loader as jl
    so = jax_native_builder()
    assert _complete_elf(so)
    torn = tmp_path / "torn.so"
    torn.write_bytes(so.read_bytes()[: so.stat().st_size // 2])
    assert not _complete_elf(torn)
    with jl._lock:
        saved = jl._lib, jl._tried
        jl._lib, jl._tried = None, True
    try:
        assert jl._get_lib() is None        # the poisoned state
        jax_native_builder()
        assert jl._get_lib() is not None
    finally:
        with jl._lock:
            if jl._lib is None:
                jl._lib, jl._tried = saved
