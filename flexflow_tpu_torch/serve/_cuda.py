"""Build and load the port's CUDA kernels.

Each source ``flexflow_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface,
``flexflow_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the
source and the flags, and loaded with ``ctypes``. The build happens at
first use (or through :func:`build`, which starts one ``nvcc`` per
source, all together). Nothing here runs at import time: the package
imports on machines without ``nvcc`` or a GPU.

Every kernel ``<name>`` has a launcher
``int <name>_launch(void* ptrs..., int dims..., float floats..., void* stream)``,
which returns ``cudaGetLastError()`` after the launch, in the library of
its source (``SOURCES``; its own name unless listed), which also exports
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
    "flash_attention_fwd": (5, 7, 1),
    "flash_attention_bwd_kv": (8, 7, 1),
    "flash_attention_bwd_q": (7, 7, 1),
    "whole_step_decode": (27, 17, 3),
}
#: kernels whose launcher lives in a source of another name
SOURCES = {
    "flash_attention_bwd_kv": "flash_attention_bwd",
    "flash_attention_bwd_q": "flash_attention_bwd",
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> str:
    """The source (``csrc/<source>.cu``) that holds kernel ``name``."""
    return SOURCES.get(name, name)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path} (set CUDA_HOME)")
    return str(path)


def _target(src_name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SRC_DIR / f"{src_name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src_name}-{digest}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the sources of every kernel in ``names`` (all when None)
    that are not built yet, one ``nvcc`` per source, all started
    together. Returns each compiled source's ``ptxas`` report; raises
    with the compiler's output if any build fails."""
    names = list(dict.fromkeys(source(n) for n in (names or SIGNATURES)))
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
    """The loaded library of kernel ``name``'s source, built if needed,
    with the argument types of every launcher it exports."""
    src = source(name)
    lib = _LIBS.get(src)
    if lib is None:
        target = _target(src)
        if not target.exists():
            build([src])
        lib = ctypes.CDLL(str(target))
        for kernel, (n_ptr, n_int, n_float) in SIGNATURES.items():
            if source(kernel) != src:
                continue
            fn = getattr(lib, f"{kernel}_launch")
            # every pointer and the stream as c_void_p: ctypes would cut a
            # bare Python int to 32 bits
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_float] * n_float + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[src] = lib
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
