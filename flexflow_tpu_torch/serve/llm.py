"""High-level ``LLM`` serving API.

Counterpart of ``flexflow_tpu/serve/llm.py``: a servable causal LM from
in-memory (family, cfg, params) — random weights from ``seed`` when no
params are given — compiled into an :class:`InferenceEngine` plus a
:class:`RequestManager`, with a blocking ``generate``.

Loading a local HF checkpoint (``from_pretrained``), SpecInfer with SSMs,
weight quantization, offload, beam search and clusters come with later
slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .batch_config import GenerationConfig, GenerationResult
from .engine import InferenceEngine, ServingConfig, resolve_device
from .request_manager import RequestManager


class LLM:
    """A servable causal LM on one device (``"cuda"`` unless the caller
    asks for another; raises when no GPU is present)."""

    def __init__(
        self,
        family: Any,
        cfg: Any,
        params: Optional[Dict[str, Any]] = None,
        *,
        tokenizer: Any = None,
        device: Any = None,
        seed: int = 0,
    ):
        self.family = family
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = family.init_params(gen, cfg, device=self.device)
        self.params = params
        self.engine: Optional[InferenceEngine] = None
        self.rm: Optional[RequestManager] = None

    def compile(
        self,
        serving: Optional[ServingConfig] = None,
        *,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
    ) -> None:
        """Build the inference engine and request manager (reference
        ``LLM.compile``). Params move to the LLM's device here."""
        serving = serving or ServingConfig()
        serving.validate()
        self.params = _to_device(self.params, self.device)
        self.engine = InferenceEngine(
            self.family, self.cfg, self.params, serving, device=self.device
        )
        self.rm = RequestManager(
            self.engine,
            tokenizer=self.tokenizer,
            eos_token_id=eos_token_id,
            seed=seed,
        )

    def generate(
        self,
        prompts: Union[str, Sequence[Union[str, Sequence[int]]]],
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
    ) -> List[GenerationResult]:
        if self.rm is None:
            self.compile()
        if gen is not None and gen.num_beams > 1:
            raise NotImplementedError(
                "num_beams > 1 is not ported yet: beam search comes with a "
                "later slice"
            )
        return self.rm.generate(prompts, gen, max_new_tokens)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
