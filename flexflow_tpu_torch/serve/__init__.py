"""Serving stack — continuous batching and incremental decoding on the
dense KV cache (counterpart of ``flexflow_tpu/serve``; the paged layout,
prefix caching, SpecInfer and clusters come with later slices)."""
from .batch_config import (
    BatchConfig,
    GenerationConfig,
    GenerationResult,
)
from .engine import InferenceEngine, ServingConfig
from .llm import LLM
from .request_manager import Request, RequestManager, RequestStatus
from .sampling import sample_tokens

__all__ = [
    "BatchConfig",
    "GenerationConfig",
    "GenerationResult",
    "InferenceEngine",
    "LLM",
    "ServingConfig",
    "Request",
    "RequestManager",
    "RequestStatus",
    "sample_tokens",
]
