"""flexflow_tpu_torch — the PyTorch/CUDA port of ``flexflow_tpu``.

The JAX package ``flexflow_tpu`` stays the reference; this package
mirrors its module names so each port module sits beside its
counterpart. It imports ``torch`` and never ``jax`` or anything of
``flexflow_tpu``: what it needs from there is copied here.

Slice served so far: LLaMA incremental-decoding serving on the dense KV
cache (``serve.LLM.generate``), whose two attention kernels are CUDA C++
for ``sm_90a`` under ``csrc/``, built on first use into ``_build/``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
from . import models, serve
from .models import llama
from .serve import LLM, InferenceEngine, RequestManager, ServingConfig

__all__ = [
    "models",
    "serve",
    "llama",
    "LLM",
    "InferenceEngine",
    "RequestManager",
    "ServingConfig",
]
