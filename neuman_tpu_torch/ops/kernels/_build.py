"""Build the CUDA sources in neuman_tpu_torch/csrc/ at first use.

Each `csrc/<name>.cu` is compiled alone by nvcc for sm_90a into a shared
library with a plain C interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [extra flags] -o _build/<name>-<hash>.so csrc/<name>.cu

The library is cached under neuman_tpu_torch/_build/ by a hash of the
source, the shared headers (csrc/*.cuh) and the flags, so an edit rebuilds and an unchanged source loads.
`--use_fast_math` is never passed: it swaps sinf for __sinf, whose error
grows with |x|, and the positional-encoding bands reach 2**9 |x|.
`-Xptxas -v` is passed: each kernel's registers, shared memory and spill bytes
are kept in `build_logs` (and beside the library, for a cached load).
"""

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOADED = {}
# seconds each library took to build in this process (0.0: loaded from cache)
build_seconds = {}
# what ptxas said about each library's kernels
build_logs = {}


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")


def load(name, extra_flags=()):
    """ctypes handle of csrc/<name>.cu, built if needed."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC, f"{name}.cu")
    flags = ["-std=c++17", "-O3", "-Xptxas=-v", *ARCH_FLAGS, *extra_flags]
    content = b""
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            content += f.read()
    digest = hashlib.sha256(content + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    t0 = time.perf_counter()
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        with open(f"{lib_path}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    build_seconds[name] = time.perf_counter() - t0
    log = f"{lib_path}.log"
    if os.path.exists(log):
        with open(log) as f:
            build_logs[name] = f.read()
    lib = ctypes.CDLL(lib_path)
    _LOADED[name] = lib
    return lib


def kernel_resources(name):
    """{kernel: {"registers", "spill_stores", "spill_loads", "stack"}} of a
    built library, from what ptxas said (function names as mangled)."""
    out, fn = {}, None
    for line in build_logs.get(name, "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out.setdefault(fn, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                          spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def check(err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
