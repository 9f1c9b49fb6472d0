"""flexflow_tpu_torch — the PyTorch/CUDA port of ``flexflow_tpu``.

The JAX package ``flexflow_tpu`` stays the reference; this package
mirrors its module names so each port module sits beside its
counterpart. It imports ``torch`` and never ``jax`` or anything of
``flexflow_tpu``: what it needs from there is copied here.

Ported so far: LLaMA serving through ``serve.LLM.generate`` on the dense
and the paged KV cache (bf16, f32, int8 and int4 pages, preemption), and
single-device LLaMA training through ``models.llama.make_train_step``
with the ``optimizers`` (SGD, Adam) and per-block remat. Their kernels —
decode, verify, ragged paged, fused RoPE + KV-write paged attention, the
whole serving step, the quantized paged commit, flash attention forward
and backward and the Adam update — are CUDA C++ for ``sm_90a`` under
``csrc/``, built on first use into ``_build/``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
from . import models, ops, optimizers, serve
from .models import llama
from .optimizers import AdamOptimizer, SGDOptimizer
from .serve import LLM, InferenceEngine, RequestManager, ServingConfig

__all__ = [
    "models",
    "ops",
    "optimizers",
    "serve",
    "llama",
    "SGDOptimizer",
    "AdamOptimizer",
    "LLM",
    "InferenceEngine",
    "RequestManager",
    "ServingConfig",
]
