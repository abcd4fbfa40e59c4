"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface and loaded with ctypes.  Nothing happens at
import: the first CUDA call builds what it needs.  `build_all()` compiles
every source at once, one `nvcc` process per file.

Libraries land in `semantichuman_torch/_build/` (git-ignored), named by a
hash of their source and flags, so an edited source is rebuilt and an
unchanged one is reused.  A library is written under a temporary name and
renamed into place, so a concurrent build never loads a half-written file.
Builds hold an exclusive lock on `_build/.lock` (flock: the kernel releases
it when its holder exits), so the processes of a data-parallel run, which
all build at first use, compile each source once and never share a build
log: the first builds, the others wait and load what it built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int

# C signature of every exported function, per source file
SIGNATURES = {
    "spiral_conv_fwd": {
        "sh_spiral_conv_fwd_tiled": ([_VOIDP] * 5 + [_INT] * 15 + [_VOIDP],
                                     _INT),
        "sh_cuda_error_string": ([_INT], ctypes.c_char_p),
    },
    "csr_reduce": {
        "sh_csr_reduce": ([_VOIDP] * 10 + [_INT] * 10 + [_VOIDP], _INT),
        "sh_cuda_error_string": ([_INT], ctypes.c_char_p),
    },
    "part_dist": {
        "sh_part_dist": ([_VOIDP] * 10 + [_INT] * 4 + [ctypes.c_float] * 2
                         + [_INT] * 3 + [_VOIDP], _INT),
        "sh_cuda_error_string": ([_INT], ctypes.c_char_p),
    },
    "banded_gather": {
        "sh_banded_gather_fwd": ([_VOIDP] * 5 + [_INT] * 6 + [_VOIDP], _INT),
        "sh_banded_gather_bwd": ([_VOIDP] * 10 + [_INT] * 6 + [_VOIDP],
                                 _INT),
        "sh_cuda_error_string": ([_INT], ctypes.c_char_p),
    },
    "spiral_conv_bwd": {
        "sh_spiral_conv_bwd_dw": ([_VOIDP] * 8 + [_INT] * 12 + [_VOIDP],
                                  _INT),
        "sh_spiral_conv_bwd_dx": ([_VOIDP] * 14 + [_INT] * 15 + [_VOIDP],
                                  _INT),
        "sh_cuda_error_string": ([_INT], ctypes.c_char_p),
    },
    "row_gather": {
        "sh_gather_rows": ([_VOIDP] * 4 + [_INT] * 8 + [_VOIDP], _INT),
        "sh_cuda_error_string": ([_INT], ctypes.c_char_p),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, out) or None when
    the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def _finish(job) -> None:
    proc, tmp, out = job
    rc = proc.wait()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (rc={rc}) building {out.name}:\n"
            + out.with_suffix(".log").read_text())
    os.replace(tmp, out)


@contextlib.contextmanager
def _build_lock():
    """Hold the build directory's lock (one build at a time across the
    host's processes)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build_all() -> dict:
    """Compile every kernel source in parallel; returns {name: library
    path}.  Build logs (with ptxas register and shared-memory counts) sit
    beside each library as `.log`."""
    with _build_lock():
        jobs = [job for job in map(_start, SIGNATURES) if job is not None]
        try:
            for job in jobs:
                _finish(job)
        finally:
            for proc, _tmp, _out in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {name: _lib_path(name) for name in SIGNATURES}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed, with
    argtypes and restype set for each exported function."""
    if not _lib_path(name).exists():
        with _build_lock():
            job = _start(name)
            if job is not None:
                _finish(job)
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.sh_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
