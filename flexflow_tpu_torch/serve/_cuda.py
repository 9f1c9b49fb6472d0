"""Build and load the port's CUDA kernels.

Each source ``flexflow_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface,
``flexflow_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the
source and the flags, and loaded with ``ctypes``. The build happens at
first use (or through :func:`build`, which starts one ``nvcc`` per
source, all together). Nothing here runs at import time: the package
imports on machines without ``nvcc`` or a GPU.

Every library exports
``int <name>_launch(void* ptrs..., int dims..., float floats..., void* stream)``,
which returns ``cudaGetLastError()`` after the launch, and
``const char* error_string(int)``. A pointer argument may be null (an
absent optional tensor).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: pointer, int and float argument counts of each kernel's launcher
SIGNATURES = {
    "decode_attention": (5, 6, 1),
    "verify_attention": (5, 7, 1),
    "ragged_paged_attention": (8, 9, 1),
    "fused_rope_paged_attention": (16, 10, 2),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path} (set CUDA_HOME)")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile every kernel in ``names`` (all when None) that is not
    built yet, one ``nvcc`` per source, all started together. Returns
    each compiled kernel's ``ptxas`` report; raises with the compiler's
    output if any build fails."""
    names = list(names or SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build([name])
        lib = ctypes.CDLL(str(target))
        n_ptr, n_int, n_float = SIGNATURES[name]
        fn = getattr(lib, f"{name}_launch")
        # every pointer and the stream as c_void_p: ctypes would cut a
        # bare Python int to 32 bits
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, tensors: List[Optional[torch.Tensor]], ints: List[int],
           floats: List[float]) -> None:
    """Launch kernel ``name`` on the current stream of the tensors'
    device (None passes a null pointer); raises if the launch was
    refused."""
    lib = _lib(name)
    n_ptr, n_int, n_float = SIGNATURES[name]
    if (len(tensors), len(ints), len(floats)) != (n_ptr, n_int, n_float):
        raise ValueError(f"{name} takes {n_ptr} pointers, {n_int} ints and "
                         f"{n_float} floats")
    device = tensors[0].device
    with torch.cuda.device(device):
        err = getattr(lib, f"{name}_launch")(
            *[None if t is None else t.data_ptr() for t in tensors],
            *[int(i) for i in ints], *[float(x) for x in floats],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.error_string(err).decode()})"
        )
