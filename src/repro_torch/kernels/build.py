"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  All missing libraries are
compiled in parallel, one nvcc per source, on first use, into
``<checkout>/build/kernels/`` (listed in ``.gitignore``).  A library's file
name carries a hash of its source, the shared header and the flags, so an
edited source is rebuilt and a stale one is never loaded.

Importing this module touches nothing: the card, nvcc and the build
directory are reached only when a kernel is first launched (or
:func:`build_all` is called, as ``chip_smoke.py`` does to time it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, List

__all__ = ["build_all", "load", "geometry", "BUILD_DIR", "NVCC_FLAGS",
           "SIGNATURES"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
#: no --use_fast_math / -ftz=true: flushing subnormals would break the
#: kernels' bitwise agreement up to powers of two (ordered_partials.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry point of each source -> its argument types (pointers and the
#: stream as c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES: Dict[str, List] = {
    # x, m, k_pad, planes, sign, rowscale, colscale, rowid, shift, last,
    # nnz, nt, L, depth, y, device, stream
    "sme_spmm_planes_decode": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _P, _I, _P],
    # x, m, k_pad, planes, sign, rowscale, rowid, shift, last, nnz, nt, L,
    # y, device, stream
    "sme_spmm_planes": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                        _I, _P],
    # x, m, k_pad, codes, sign, rowscale, rowid, nnz, nt, L, y, device,
    # stream
    "sme_spmm": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P],
    # x, m, k_pad, packed, rowscale, rowid, nnz, nt, L, y, device, stream
    "sme_spmm6": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P],
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _library(name: str) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel whose library is missing, all nvcc processes
    at once.  Returns ``{name: ptxas report}`` for the ones built now
    (empty when everything was cached); raises with nvcc's output if any
    build fails."""
    todo = {name: _library(name) for name in SIGNATURES
            if not _library(name).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so",
                                          delete=False)
        tmp.close()
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp.name, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       pathlib.Path(tmp.name), lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)                 # atomic: never a torn .so
            reports[name] = out
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def geometry(name: str, *sizes: int) -> Dict[str, int]:
    """Launch shape of kernel ``name`` at ``sizes`` (the arguments of its
    ``<name>_geometry`` export: m, k_pad, nt, L, and depth for
    ``sme_spmm_planes_decode``): grid, cluster size and dynamic shared
    memory.  Raises
    where the export refuses the sizes (more shared memory than a block
    has), as the launch would."""
    fn = getattr(load(name), f"{name}_geometry")
    fn.argtypes = [_I] * len(sizes) + [_P]
    fn.restype = _I
    out = (ctypes.c_int * 4)()
    err = fn(*sizes, ctypes.cast(out, _P))
    if err:
        raise RuntimeError(f"{name} cannot launch at {sizes}: CUDA error "
                           f"{err} ({out[3]} B of shared memory)")
    return dict(zip(("grid_x", "grid_y", "cluster", "smem_bytes"), out))
