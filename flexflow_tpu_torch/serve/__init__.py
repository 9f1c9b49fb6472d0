"""Serving stack — continuous batching, incremental decoding, SpecInfer
(token trees from SSMs or the target's own first layers, verified in one
step) and beam search on the dense or the paged KV cache, with bf16,
f32, int8 or int4 pages (counterpart of ``flexflow_tpu/serve``; prefix
caching and clusters come with later slices)."""
from .batch_config import (
    BatchConfig,
    GenerationConfig,
    GenerationResult,
)
from .engine import InferenceEngine, ServingConfig
from .llm import LLM, SSM
from .paging import PageAllocator
from .request_manager import Request, RequestManager, RequestStatus
from .sampling import sample_tokens
from .specinfer import SpecConfig, SpecInferManager, TokenTree, merge_trees

__all__ = [
    "BatchConfig",
    "GenerationConfig",
    "GenerationResult",
    "InferenceEngine",
    "LLM",
    "SSM",
    "PageAllocator",
    "ServingConfig",
    "Request",
    "RequestManager",
    "RequestStatus",
    "sample_tokens",
    "SpecConfig",
    "SpecInferManager",
    "TokenTree",
    "merge_trees",
]
