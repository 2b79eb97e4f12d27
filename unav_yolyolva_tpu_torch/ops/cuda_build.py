"""Builds the hand-written Hopper kernels in `csrc/` and loads them.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, bound with ctypes (no PyTorch headers, so
a build takes seconds). Libraries go into `build/kernels/` at the root of
the checkout, named by a hash of their sources, and are built at first use;
`build()` compiles several at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("mhca", "mhca_bwd", "csp", "csp_bwd", "nms", "tblock", "tblock_bwd",
                  "gemm_tc", "mhca_bf16", "csp_bf16", "tblock_bf16", "gemm_bf16",
                  "mhca_bwd_bf16", "csp_bwd_bf16", "tblock_bwd_bf16", "conv3_tc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

# ctypes shorthands for the argtypes tables of the wrappers
PTR, INT, LONG, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float

_loaded: Dict[Tuple[str, Optional[str]], ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, source: Optional[Path] = None) -> Path:
    """Where the library `name` is built from `source` (by default
    `csrc/<name>.cu`): named by a hash of that file and the headers beside it."""
    source = Path(source) if source else CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for f in sorted(source.parent.glob("*.cuh")) + [source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libunav_{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES,
          sources: Optional[Dict[str, Path]] = None) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, all nvcc
    processes at once; `sources` {name: path} builds another file (e.g.
    another checkout's `csrc/<name>.cu`) under a name. Returns {name: ptxas
    report} of what was compiled; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source = (sources or {}).get(name) or CSRC / f"{name}.cu"
        out = library_path(name, source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def library(name: str, argtypes: Dict[str, Sequence],
            restypes: Dict[str, Tuple[Sequence, type]] = None,
            source: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed, with `argtypes`
    declared on its entry points (each returns a cudaError_t as int) and
    `restypes` {fn: (argtypes, restype)} on its other functions. `source`
    binds another file in place of `csrc/<name>.cu` (the wrappers keep
    using this checkout's)."""
    key = (name, str(source) if source else None)
    lib = _loaded.get(key)
    if lib is None:
        build([name], {name: Path(source)} if source else None)
        lib = ctypes.CDLL(str(library_path(name, source)))
        table = {fn: (types, ctypes.c_int) for fn, types in argtypes.items()}
        table.update(restypes or {})
        for fn, (types, res) in table.items():
            f = getattr(lib, fn)
            f.argtypes = list(types)
            f.restype = res
        lib.unav_error_string.argtypes = [ctypes.c_int]
        lib.unav_error_string.restype = ctypes.c_char_p
        _loaded[key] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.unav_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

