"""Serving stack — continuous batching, incremental decoding, SpecInfer
(token trees from SSMs or the target's own first layers, verified in one
step) and beam search on the dense or the paged KV cache, with bf16,
f32, int8 or int4 pages, automatic prefix caching with its host tier on
the paged one, weight-only int8/int4 quantized and offloaded params, and
in-process clusters of engine replicas behind a router (serve/cluster/;
counterpart of ``flexflow_tpu/serve``)."""
from .batch_config import (
    BatchConfig,
    GenerationConfig,
    GenerationResult,
)
from .cluster import ClusterManager
from .engine import InferenceEngine, ServingConfig
from .llm import LLM, SSM
from .paging import PageAllocator
from .prefix_cache import PrefixCache
from .request_manager import Request, RequestManager, RequestStatus
from .sampling import sample_tokens
from .specinfer import SpecConfig, SpecInferManager, TokenTree, merge_trees

__all__ = [
    "BatchConfig",
    "ClusterManager",
    "GenerationConfig",
    "GenerationResult",
    "InferenceEngine",
    "LLM",
    "SSM",
    "PageAllocator",
    "PrefixCache",
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
