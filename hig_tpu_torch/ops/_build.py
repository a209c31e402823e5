"""Build the CUDA sources under ``hig_tpu_torch/csrc`` with nvcc and load them
with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``hig_tpu_torch/_build/lib<name>-<hash>.so``, where the hash covers the
source and every header of ``csrc``, so an edited source is rebuilt and a
built one is reused. The attention sources are built once per head width
they take (:data:`HEAD_WIDTHS`): the width is the compile-time constant
``HIG_HD`` of the translation unit, and width w's library (w other than
64) is ``lib<name>_hd<w>-<hash>.so``, so each width is one nvcc process of
its own (17 libraries in all).
Nothing is built when a module is imported: the first wrapper call on a
CUDA tensor builds its library, and :func:`build_all` builds every library
at once, one nvcc process per library.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("fused_block", "projected_attention", "efficient_attention", "flash_attention",
           "bf16_sum")
# The head widths each attention kernel is built for (``HIG_HD``), in order;
# the first is the unsuffixed library.
HEAD_WIDTHS = (64, 128, 16, 32)
WIDTH_SOURCES = ("fused_block", "projected_attention", "efficient_attention", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_name(name: str, hd: int = 64) -> str:
    """The library of source ``name`` at head width ``hd`` (64: the source's
    own name)."""
    if hd not in HEAD_WIDTHS:
        raise ValueError(f"no kernel library for head width {hd}; built: {HEAD_WIDTHS}")
    return name if hd == HEAD_WIDTHS[0] else f"{name}_hd{hd}"


def libraries() -> tuple:
    """Every library :func:`build_all` builds: each source, and each
    attention source at the other head widths."""
    return SOURCES + tuple(library_name(n, hd) for hd in HEAD_WIDTHS[1:] for n in WIDTH_SOURCES)


def _source(lib: str) -> tuple[str, int]:
    """(source name, head width) of a library name."""
    name, _, hd = lib.partition("_hd")
    return (name, int(hd)) if hd else (lib, HEAD_WIDTHS[0])


def _flags(lib: str) -> tuple:
    _, hd = _source(lib)
    return NVCC_FLAGS + ((f"-DHIG_HD={hd}",) if hd != HEAD_WIDTHS[0] else ())


def library_path(lib: str) -> str:
    name, _ = _source(lib)
    h = hashlib.sha1()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(lib)).encode())
    return os.path.join(BUILD_DIR, f"lib{lib}-{h.hexdigest()[:12]}.so")


def _start_build(lib: str) -> tuple[subprocess.Popen, str, str] | None:
    out = library_path(lib)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_flags(lib), "-I", CSRC_DIR, "-o", tmp,
           os.path.join(CSRC_DIR, f"{_source(lib)[0]}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(job: tuple[subprocess.Popen, str, str], log: dict) -> None:
    proc, tmp, out = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {os.path.basename(out)}:\n{text}")
    os.replace(tmp, out)
    log[os.path.basename(out)] = text


def build_all(names=None) -> dict:
    """Build every library that is missing, all nvcc processes at once.

    Returns {library file: nvcc output (register and shared-memory use)}
    for the libraries built by this call, and the seconds it took under
    ``"seconds"``.
    """
    t0 = time.perf_counter()
    jobs = [job for job in (_start_build(n) for n in names or libraries()) if job is not None]
    log: dict = {}
    try:
        for job in jobs:
            _finish_build(job, log)
    finally:
        for proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    log["seconds"] = time.perf_counter() - t0
    return log


@functools.cache
def load(lib: str) -> ctypes.CDLL:
    """The loaded library ``lib`` (:func:`library_name`), built first if needed."""
    path = library_path(lib)
    if not os.path.exists(path):
        build_all((lib,))
    return ctypes.CDLL(path)


@functools.cache
def _entry(name: str, entry: str, n_pointers: int, n_ints: int):
    lib = load(name)
    fn = getattr(lib, f"hig_{entry}")
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hig_error_string.argtypes = [ctypes.c_int]
    lib.hig_error_string.restype = ctypes.c_char_p
    return fn, lib.hig_error_string


def launch(name: str, tensors, ints, stream: int, entry: str | None = None,
           hd: int = 64) -> None:
    """Call ``hig_<entry>`` (default ``hig_<name>``) of ``csrc/<name>.cu``'s
    library for head width ``hd`` with the tensors' device pointers, then the
    ints, then the CUDA stream handle; raise if it returns a CUDA error (a
    refused launch never runs, and a later synchronize would not report it)."""
    fn, error_string = _entry(library_name(name, hd), entry or name, len(tensors), len(ints))
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{name} kernel: {error_string(err).decode()}")
