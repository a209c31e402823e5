"""ctypes binding of the native C++ batch loader (``native/loader.cpp``), the
port's own counterpart of ``hig_tpu/data/native_loader.py``.

Clips live in a C++ store; a batch (each clip windowed, Z-normalized and
role-swapped into a fixed (B, 2, window + 1, D) shape) is filled by
multithreaded native code. The window shifts come from a counter RNG of
(seed, epoch, clip, slot), so batches are reproducible, and equal to the
JAX package's native batches bit for bit, but not to the Python loader's
numpy streams. The trainer takes this path under ``--use_native_loader``
(``Trainer._native_epoch_batches``).

The library is built with g++ from the repository's ``native/loader.cpp``
(``native/build.sh``'s flags) into ``hig_tpu_torch/_build/``, beside the
CUDA libraries, at first use: ``libhig_loader-<hash>.so``, the hash of the
source and the flags. Unlike the JAX binding, which quietly falls back to
the Python loader, a build or load that fails raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from hig_tpu_torch.ops._build import BUILD_DIR, PKG_DIR

SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "loader.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> str:
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhig_loader-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Build the library if it is missing; returns its path. Raises with
    g++'s output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the native batch loader needs g++ on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed, with the five entry
    points' signatures set."""
    path = build()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load the native batch loader {path}: {e}") from e
    lib.hig_store_create.restype = ctypes.c_void_p
    lib.hig_store_create.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.hig_store_destroy.argtypes = [ctypes.c_void_p]
    lib.hig_store_add_clip.restype = ctypes.c_int64
    lib.hig_store_add_clip.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
    ]
    lib.hig_store_size.restype = ctypes.c_int64
    lib.hig_store_size.argtypes = [ctypes.c_void_p]
    lib.hig_sample_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeClipStore:
    """Owns the C++ store: the clips of a PairDataset, raw (2, T, D), and
    the feature statistics (D + 4,) they are normalized with."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        lib = load()
        self._lib = lib
        if mean.shape != std.shape or mean.ndim != 1:
            raise ValueError(f"mean and std must be one (D + 4,) shape, got {mean.shape}, "
                             f"{std.shape}")
        self.D = int(mean.shape[0] - 4)
        mean32 = np.ascontiguousarray(mean, np.float32)
        std32 = np.ascontiguousarray(std, np.float32)
        self._handle = ctypes.c_void_p(lib.hig_store_create(_fptr(mean32), _fptr(std32), self.D))

    def add_clip(self, motion: np.ndarray) -> int:
        if motion.ndim != 3 or motion.shape[0] != 2 or motion.shape[2] != self.D:
            raise ValueError(f"a clip is (2, T, {self.D}), got {motion.shape}")
        m = np.ascontiguousarray(motion, np.float32)
        return int(self._lib.hig_store_add_clip(self._handle, _fptr(m), m.shape[1], m.shape[2]))

    def __len__(self) -> int:
        return int(self._lib.hig_store_size(self._handle))

    def sample_batch(self, clip_indices: np.ndarray, window: int = 90, seed: int = 0,
                     epoch: int = 0, swap_flags: np.ndarray | None = None,
                     num_threads: int = 0):
        """→ (motion (B, 2, window + 1, D) float32, lengths (B,) int32);
        ``num_threads`` 0 takes min(8, CPUs). The batch does not depend on
        the thread count."""
        B = len(clip_indices)
        idx = np.ascontiguousarray(clip_indices, np.int64)
        out = np.empty((B, 2, window + 1, self.D), np.float32)
        lengths = np.empty((B,), np.int32)
        swap_ptr = None
        if swap_flags is not None:
            swap_flags = np.ascontiguousarray(swap_flags, np.uint8)
            swap_ptr = swap_flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        num_threads = num_threads or min(8, os.cpu_count() or 1)
        self._lib.hig_sample_batch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), swap_ptr, B,
            window, seed, epoch, _fptr(out),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
        return out, lengths

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.hig_store_destroy(handle)
            self._handle = None


def store_from_dataset(dataset) -> tuple[NativeClipStore, np.ndarray]:
    """A native store of a PairDataset's clips and its swap flags: 1 where
    the dataset's pseudo-labels swap the clip's actors."""
    store = NativeClipStore(np.asarray(dataset.mean), np.asarray(dataset.std))
    swaps = np.zeros(len(dataset.clips), np.uint8)
    for i, clip in enumerate(dataset.clips):
        store.add_clip(clip.motion)
        if dataset.labels is not None and dataset.labels.get(clip.name, 0) == 1:
            swaps[i] = 1
    return store, swaps
