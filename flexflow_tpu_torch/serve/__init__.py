"""Serving stack — continuous batching and incremental decoding on the
dense or the paged KV cache, with bf16, f32, int8 or int4 pages
(counterpart of ``flexflow_tpu/serve``; prefix caching, SpecInfer and
clusters come with later slices)."""
from .batch_config import (
    BatchConfig,
    GenerationConfig,
    GenerationResult,
)
from .engine import InferenceEngine, ServingConfig
from .llm import LLM
from .paging import PageAllocator
from .request_manager import Request, RequestManager, RequestStatus
from .sampling import sample_tokens

__all__ = [
    "BatchConfig",
    "GenerationConfig",
    "GenerationResult",
    "InferenceEngine",
    "LLM",
    "PageAllocator",
    "ServingConfig",
    "Request",
    "RequestManager",
    "RequestStatus",
    "sample_tokens",
]
