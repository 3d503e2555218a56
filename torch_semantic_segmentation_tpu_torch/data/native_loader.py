"""ctypes binding of the port to the native C++ batch loader
(`native/tpu_seg_loader.cpp`, the JAX package's `data/native_loader.py`).

A C++ thread pool decodes JPEG/PNG pairs (libjpeg, libpng) into a ring of
uint8 NHWC batches, applies the optional 256-entry label LUT during the
copy, and hands the batches out strictly in order; the ctypes call releases
the GIL, so decoding overlaps the train step and the copy to the card.

The library is built at first use by g++ from the checkout's
`native/tpu_seg_loader.cpp` into the port's `_build/`, keyed by a hash of
the source and the flags, and reused by later calls and processes
(`kernels.compile_library`, as for the `.cu` sources). A failed build
raises with the compiler's output: there is no silent switch to the Python
loader (`pipeline.batch_iterator`), which a caller picks by name.
`native_available()` only asks whether the library builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import typing as tp
from pathlib import Path

import numpy as np
import torch

from torch_semantic_segmentation_tpu_torch.kernels import compile_library

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "tpu_seg_loader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
LIBS = ("-ljpeg", "-lpng")


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libtpu_seg_loader-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader is built from "
                           f"{SOURCE} with g++, libjpeg and libpng")
    return compile_library(
        out, lambda tmp: [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS],
        SOURCE.name).path


@functools.lru_cache(maxsize=None)
def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.loader_error.restype = ctypes.c_char_p
    lib.loader_error.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load_lib()
        return True
    except (RuntimeError, OSError):
        return False


def decode_image(path: str, channels: int = 3,
                 max_side: int = 8192) -> np.ndarray:
    """Decode one JPEG or PNG by the native codecs: (H, W, 3) RGB for
    `channels=3`, (H, W) for `channels=1` (a palette PNG keeps its palette
    index, an RGB one becomes libpng's gray)."""
    lib = _load_lib()
    # np.empty maps the buffer lazily: only the decoded bytes are touched
    buf = np.empty((max_side * max_side * channels,), np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    ok = lib.decode_image(str(path).encode(),
                          buf.ctypes.data_as(ctypes.c_void_p),
                          ctypes.byref(h), ctypes.byref(w), channels,
                          buf.size)
    if not ok:
        raise IOError(f"native decode failed: {path}")
    arr = buf[: h.value * w.value * channels]
    shape = (h.value, w.value, channels) if channels > 1 else (h.value, w.value)
    return arr.reshape(shape).copy()


def _pointer(a) -> ctypes.c_void_p:
    """The data pointer of a C-contiguous uint8 numpy array or CPU tensor."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu" or a.dtype != torch.uint8 \
                or not a.is_contiguous():
            raise ValueError("out= takes contiguous uint8 CPU tensors")
        return ctypes.c_void_p(a.data_ptr())
    if a.dtype != np.uint8 or not a.flags.c_contiguous:
        raise ValueError("out= takes C-contiguous uint8 arrays")
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeBatchLoader:
    """Iterator of (images (B,H,W,3) uint8, labels (B,H,W) uint8) host
    batches, or images alone without label paths. Batch k of a (paths,
    batch_size, seed) stream is the same for any thread count; each epoch
    is a fresh (seed, epoch) permutation, the last partial batch dropped.
    `start_batch` resumes the stream at batch k; `sample_slice=(lo, hi)`
    decodes only those samples of each batch."""

    def __init__(self, image_paths: tp.Sequence[str],
                 label_paths: tp.Sequence[str] | None,
                 batch_size: int, height: int, width: int, *,
                 num_threads: int = 4, prefetch: int = 3,
                 label_lut: np.ndarray | None = None, seed: int = 0,
                 shuffle: bool = True, epochs: int = 0,
                 start_batch: int = 0,
                 sample_slice: tuple[int, int] | None = None):
        lib = _load_lib()
        n = len(image_paths)
        if label_paths is not None and len(label_paths) != n:
            raise ValueError("image/label path count mismatch")
        lo, hi = sample_slice if sample_slice is not None else (0, batch_size)
        if not 0 <= lo < hi <= batch_size:
            raise ValueError(f"bad sample_slice {sample_slice} for batch "
                             f"{batch_size}")
        self._imgs = (ctypes.c_char_p * n)(*[str(p).encode()
                                             for p in image_paths])
        self._lbls = ((ctypes.c_char_p * n)(*[str(p).encode()
                                              for p in label_paths])
                      if label_paths is not None else None)
        lut_buf = (bytes(np.asarray(label_lut, np.uint8))
                   if label_lut is not None else None)
        self._handle = lib.loader_create(
            self._imgs, self._lbls, n, batch_size, height, width,
            num_threads, prefetch, lut_buf, seed, int(shuffle), epochs,
            start_batch, lo, hi)
        if not self._handle:
            raise RuntimeError("loader_create failed")
        self._lib = lib
        self._shape = (hi - lo, height, width)
        self._has_labels = label_paths is not None

    @property
    def batch_shapes(self) -> tuple[tuple[int, ...], ...]:
        """The shapes of one batch's arrays: images, then labels."""
        b, h, w = self._shape
        return ((b, h, w, 3), (b, h, w)) if self._has_labels else ((b, h, w, 3),)

    def __iter__(self):
        return self

    def __next__(self, out=None):
        """The next batch. With `out` (a pair of uint8 arrays or CPU
        tensors of `batch_shapes`, C-contiguous; pinned memory too) the
        loader copies it straight into them and returns them."""
        if out is None:
            out = tuple(np.empty(s, np.uint8) for s in self.batch_shapes)
        elif tuple(tuple(a.shape) for a in out) != self.batch_shapes:
            raise ValueError(f"out= shapes {[tuple(a.shape) for a in out]}, "
                             f"expected {self.batch_shapes}")
        rc = self._lib.loader_next(
            self._handle, _pointer(out[0]),
            _pointer(out[1]) if self._has_labels else None)
        if rc == 0:
            raise StopIteration
        if rc < 0:
            raise IOError(self._lib.loader_error(self._handle).decode())
        return tuple(out) if self._has_labels else out[0]

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def native_batch_iterator(dataset, batch_size: int, *, shuffle: bool = True,
                          seed: int = 0, num_threads: int = 4,
                          prefetch: int = 3, epochs: int = 0,
                          label_lut: np.ndarray | None = None,
                          height: int | None = None,
                          width: int | None = None,
                          start_batch: int = 0,
                          sample_slice: tuple[int, int] | None = None
                          ) -> NativeBatchLoader:
    """`pipeline.batch_iterator`'s stream by the native loader, over a
    dataset of path pairs (`image_paths`, `label_paths`: Cityscapes, BDD,
    Mapillary's palette masks, CamVid's index masks; CamVid's RGB masks
    and its void id 11 need the dataset's own `__getitem__`, so
    `batch_iterator`). The first image gives H x W unless
    given; a file of another size is resized to it (bilinear, labels
    nearest)."""
    paths = getattr(dataset, "image_paths", None)
    lbls = getattr(dataset, "label_paths", None)
    if paths is None:
        raise TypeError("dataset has no image_paths; use "
                        "pipeline.batch_iterator")
    if height is None or width is None:
        probe = decode_image(paths[0], 3)
        height, width = probe.shape[0], probe.shape[1]
    return NativeBatchLoader(paths, lbls, batch_size, height, width,
                             num_threads=num_threads, prefetch=prefetch,
                             label_lut=label_lut, seed=seed, shuffle=shuffle,
                             epochs=epochs, start_batch=start_batch,
                             sample_slice=sample_slice)
