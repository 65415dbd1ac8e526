"""ctypes bridge to the port's image codecs (``csrc/imageio.cpp``).

Counterpart of ``handpose_tpu/data/native_decode.py:93-131``.  The library
is built with the host's ``g++`` at first use (``ops/cuda_build.py``) into
``build/kernels/``; it needs zlib and nothing else.  There is no other
route: if the library cannot be built or loaded, every call raises, naming
what the compiler or loader missed.

A batch decodes inside one C++ call on a thread pool, so the interpreter
lock is released for the whole batch.  Files are routed by their magic
bytes, not their names: PNG, else JPEG.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from ..ops import cuda_build

SOURCE = "imageio"
_ERRLEN = 512
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = cuda_build.load(SOURCE)
            except OSError as e:
                raise RuntimeError(
                    f"the image codec library (csrc/{SOURCE}.cpp) was built "
                    f"but does not load: {e}") from e
            lib.imageio_decode_batch.restype = ctypes.c_int
            lib.imageio_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int]
            for fn in (lib.imageio_write_png, lib.imageio_write_jpeg):
                fn.restype = ctypes.c_int
            lib.imageio_write_png.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.imageio_write_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.imageio_abi_version.restype = ctypes.c_int
            if lib.imageio_abi_version() != 1:
                raise RuntimeError("csrc/imageio.cpp ABI version mismatch")
            _lib = lib
        return _lib


def _check_out(out: np.ndarray, size: int) -> None:
    # explicit checks (asserts vanish under python -O, and the C side
    # writes every byte of every slot)
    if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous uint8 array")
    if out.size != size:
        raise ValueError(f"out has {out.size} elements; need {size}")
    if not out.flags.writeable:
        raise ValueError("out must be writable (got a read-only view; "
                         "copy the memmap slice first)")


def _decode(paths: Sequence[str], hw: np.ndarray, pad_hw, C: int,
            n_threads: int, out: np.ndarray) -> np.ndarray:
    lib = _load()
    n = len(paths)
    Ht, Wt = (int(v) for v in pad_hw)
    _check_out(out, n * Ht * Wt * C)
    hw = np.ascontiguousarray(hw, np.int32).reshape(n, 2)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.imageio_decode_batch(
        arr, n, hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data, Ht, Wt, C, int(n_threads), err, _ERRLEN)
    if rc < 0:
        raise RuntimeError("the image decoder could not start a thread")
    if rc:
        raise OSError(f"cannot decode {str(paths[rc - 1])!r}: "
                      f"{err.value.decode(errors='replace')}")
    return out


def decode_batch(paths: Sequence[str], H: int, W: int, C: int = 3,
                 n_threads: int = 8,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """PNG/JPEG files of one size H x W -> (B, H, W, 3) RGB (C=3) or
    (B, H, W) gray (C=1) uint8.  Raises ``OSError`` naming the first
    failing file: missing, corrupt, unsupported or of another size.
    Pass ``out`` to decode into a preallocated buffer."""
    n = len(paths)
    if out is None:
        out = np.empty((n, H, W, C) if C > 1 else (n, H, W), np.uint8)
    return _decode(paths, np.tile([H, W], (n, 1)), (H, W), C, n_threads,
                   out)


def decode_padded(paths: Sequence[str], hw, pad_hw, n_threads: int = 8,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """RGB files of differing sizes -> one zero-padded (B, Ht, Wt, 3)
    uint8 buffer, image i in the top-left hw[i] = (h, w) of its slot.
    ``hw`` comes from the annotations; a file of another size raises
    ``OSError`` naming it."""
    n = len(paths)
    hw = np.asarray(hw, np.int64).reshape(n, 2)
    Ht, Wt = (int(v) for v in pad_hw)
    if n and (hw[:, 0].max() > Ht or hw[:, 1].max() > Wt):
        raise ValueError(f"an image of {hw.max(0).tolist()} does not fit "
                         f"the padded size {(Ht, Wt)}")
    if out is None:
        out = np.empty((n, Ht, Wt, 3), np.uint8)
    return _decode(paths, hw, (Ht, Wt), 3, n_threads, out)


def _image_arg(img: np.ndarray):
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        return img, img.shape[0], img.shape[1], 1
    if img.ndim == 3 and img.shape[2] in (1, 3):
        return img, img.shape[0], img.shape[1], img.shape[2]
    raise ValueError(f"image of shape {img.shape}: want (H, W), (H, W, 1) "
                     "or (H, W, 3)")


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) RGB or (H, W) gray uint8 image as PNG (the
    counterpart of ``cv2.imwrite`` of its BGR or gray array)."""
    lib = _load()
    img, H, W, C = _image_arg(img)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.imageio_write_png(str(path).encode(), img.ctypes.data, H, W, C,
                             err, _ERRLEN):
        raise OSError(f"cannot write {str(path)!r}: {err.value.decode()}")


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write an (H, W, 3) RGB or (H, W) gray uint8 image as a baseline
    JPEG, 4:2:0 for RGB, at ``quality`` (95 is ``cv2.imwrite``'s
    default)."""
    lib = _load()
    img, H, W, C = _image_arg(img)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.imageio_write_jpeg(str(path).encode(), img.ctypes.data, H, W, C,
                              int(quality), err, _ERRLEN):
        raise OSError(f"cannot write {str(path)!r}: {err.value.decode()}")
