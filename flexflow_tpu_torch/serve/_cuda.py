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
absent optional tensor). The libraries of the kernels in ``DESIGNS``
also export ``int <name>_design(int...)``, the block design their
launcher takes for the given sizes (:func:`design`); the whole-step
library also reports its shared memory (:func:`whole_step_smem`).
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
    "decode_attention": (7, 7, 1),
    "verify_attention": (5, 7, 1),
    "ragged_paged_attention": (10, 10, 1),
    "fused_rope_paged_attention": (18, 11, 2),
    "flash_attention_fwd": (5, 7, 1),
    "flash_attention_bwd_kv": (8, 7, 1),
    "flash_attention_bwd_q": (7, 7, 1),
    "whole_step_decode": (29, 19, 3),
    "paged_commit": (8, 9, 1),
    "adam_update": (5, 3, 6),
}
#: kernels whose launcher lives in a source of another name
SOURCES = {
    "flash_attention_bwd_kv": "flash_attention_bwd",
    "flash_attention_bwd_q": "flash_attention_bwd",
}

#: the paged kernels' block designs, by the code their ``<name>_design`` returns
PAGED_DESIGNS = ("decode", "mma", "tf32x3")
#: kernels whose library exports ``int <name>_design(int...)``: the block
#: designs by the code it returns, and its arguments
DESIGNS = {
    "ragged_paged_attention": (PAGED_DESIGNS, ("C", "H", "KV", "dtype")),
    "fused_rope_paged_attention": (PAGED_DESIGNS, ("C", "H", "KV", "dtype")),
    "verify_attention": (("rows8", "mma", "f32", "tf32x3"), ("C", "H", "KV", "dtype")),
    "whole_step_decode": (PAGED_DESIGNS, ("C", "H", "KV", "dtype")),
    "flash_attention_fwd": (("f32", "wgmma"), ("dtype",)),
    "flash_attention_bwd_kv": (("f32", "wgmma"), ("dtype",)),
    "flash_attention_bwd_q": (("f32", "wgmma"), ("dtype",)),
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
        for kernel, (_, args) in DESIGNS.items():
            if source(kernel) == src:
                getattr(lib, f"{kernel}_design").argtypes = [ctypes.c_int] * len(args)
                getattr(lib, f"{kernel}_design").restype = ctypes.c_int
        if src == "whole_step_decode":
            lib.whole_step_decode_smem.argtypes = [ctypes.c_int] * 3 + [
                ctypes.POINTER(ctypes.c_int)] * 3
            lib.whole_step_decode_smem.restype = ctypes.c_int
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


def design(name: str, *ints: int) -> str:
    """The block design (one of ``DESIGNS[name][0]``) that kernel
    ``name``'s launcher takes for the sizes ``DESIGNS[name][1]`` (C query
    tokens per slot, H query and KV key/value heads, the dtype code of
    q)."""
    names, args = DESIGNS[name]
    if len(ints) != len(args):
        raise ValueError(f"{name}_design takes {', '.join(args)}")
    return names[getattr(_lib(name), f"{name}_design")(*ints)]


def whole_step_smem(dtype: int, pool_kind: int, dk: int):
    """The whole-step kernel's shared memory as its library reports it for
    q of dtype code ``dtype``, pools of ``pool_kind`` (0 q's type, 1 int8,
    2 int4) and head dim ``dk``: the tensor-core attention tile's dynamic
    bytes (``MmaSmem``), the kernel's static bytes (from
    ``cudaFuncGetAttributes``; needs the GPU) and the split decode walk's
    dynamic bytes before its live slots (``SplitLayout::kSlots``)."""
    lib = _lib("whole_step_decode")
    mma, static, split = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.whole_step_decode_smem(dtype, pool_kind, dk, ctypes.byref(mma),
                                     ctypes.byref(static), ctypes.byref(split))
    if err != 0:
        raise RuntimeError(f"whole_step_decode_smem failed: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
    return mma.value, static.value, split.value
