"""The host Soft-NMS: a ctypes binding of the repository's C scan
(`native/nms1d.c`), an independent cross-check of the Soft-NMS kernels and
their plain versions (ops/fused_nms.py). No path of the port falls back to
it, and it falls back to nothing.

The library is compiled with gcc (`-O3 -shared -fPIC ... -lm`) at first use
into `build/host/` at the root of the checkout, named by a hash of the
source, written under a temporary name and moved into place so that
parallel processes never load a half-written file; nothing is written
beside the source. Without a compiler, or if the build fails, the calls
raise NativeUnavailable with the compiler's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "nms1d.c"
BUILD_DIR = ROOT / "build" / "host"
CC = "gcc"

_LIB: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    """The host scan's library cannot be built or loaded."""


def library_path() -> Path:
    """Where the library is built: named by a hash of the source's bytes."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libnms1d-{digest}.so"


def build() -> Path:
    """Compile the source into its library unless it is there; returns the
    library's path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CC, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE), "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except OSError as e:
        raise NativeUnavailable(f"host NMS build failed: {e}") from e
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"host NMS build failed: {e}\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.soft_nms_1d.restype = ctypes.c_int64
        lib.soft_nms_1d.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int64, i64p, f32p,
        ]
        lib.hard_nms_1d.restype = ctypes.c_int64
        lib.hard_nms_1d.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
            i64p, f32p,
        ]
        _LIB = lib
    return _LIB


def _prepare(segs, scores, max_out):
    segs = np.ascontiguousarray(segs, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = segs.shape[0]
    max_out = n if max_out is None else min(max_out, n)
    return segs, scores, n, np.zeros(max_out, np.int64), np.zeros(max_out, np.float32)


def soft_nms_host(segs: np.ndarray, scores: np.ndarray, iou_threshold: float, sigma: float,
                  min_score: float, method: int = 2, max_out: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential Soft-NMS of one row: segs (N, 2), scores (N,); method 0
    hard, 1 linear, 2 Gaussian. Returns (selected indices, their decayed
    scores) in selection order; a lane dies once its score falls under
    min_score."""
    segs, scores, n, out_idx, out_scores = _prepare(segs, scores, max_out)
    k = _lib().soft_nms_1d(segs, scores, n, iou_threshold, sigma, min_score, method,
                           len(out_idx), out_idx, out_scores)
    if k < 0:
        raise RuntimeError("native soft_nms_1d failed")
    return out_idx[:k], out_scores[:k]


def hard_nms_host(segs: np.ndarray, scores: np.ndarray, iou_threshold: float,
                  max_out: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy hard NMS of one row: scores never decay, lanes at IoU >=
    iou_threshold with a selected one die. Returns (indices, scores)."""
    segs, scores, n, out_idx, out_scores = _prepare(segs, scores, max_out)
    k = _lib().hard_nms_1d(segs, scores, n, iou_threshold, len(out_idx), out_idx, out_scores)
    if k < 0:
        raise RuntimeError("native hard_nms_1d failed")
    return out_idx[:k], out_scores[:k]
