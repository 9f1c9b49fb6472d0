"""High-level ``LLM`` serving API.

Counterpart of ``flexflow_tpu/serve/llm.py``: a servable causal LM from
in-memory (family, cfg, params) — random weights from ``seed`` when no
params are given — compiled into an :class:`InferenceEngine` plus a
:class:`RequestManager`, with a blocking ``generate``. ``compile(ssms=,
spec=)`` serves SpecInfer (serve/specinfer.py): each SSM ``LLM`` gets an
engine with the same ``ServingConfig`` and the manager becomes a
:class:`SpecInferManager`; ``SpecConfig(draft="early_exit")`` without
SSMs self-speculates. ``generate`` with ``num_beams > 1`` beam-searches
(serve/beam.py).

Loading a local HF checkpoint (``from_pretrained``), weight
quantization, offload and clusters come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .batch_config import GenerationConfig, GenerationResult
from .engine import InferenceEngine, ServingConfig, resolve_device
from .request_manager import RequestManager
from .specinfer import SpecConfig, SpecInferManager


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
        ssms: Sequence["LLM"] = (),
        spec: Optional[SpecConfig] = None,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
    ) -> None:
        """Build the inference engine(s) and request manager (reference
        ``LLM.compile``). Params move to the LLM's device here. With
        ``ssms`` (or ``spec.draft == "early_exit"``) the manager runs the
        SpecInfer loop; each SSM gets an engine on this LLM's device with
        the same ``serving``."""
        serving = serving or ServingConfig()
        serving.validate()
        self.params = _to_device(self.params, self.device)
        self.engine = InferenceEngine(
            self.family, self.cfg, self.params, serving, device=self.device
        )
        if ssms or getattr(spec, "draft", "ssm") == "early_exit":
            for ssm in ssms:
                ssm.params = _to_device(ssm.params, self.device)
                ssm.engine = InferenceEngine(ssm.family, ssm.cfg, ssm.params, serving,
                                             device=self.device)
            self.rm = SpecInferManager(
                self.engine, [s.engine for s in ssms], spec,
                tokenizer=self.tokenizer, eos_token_id=eos_token_id, seed=seed,
            )
            return
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
            from .beam import generate_with_beams

            if gen.do_sample:
                # beam scoring ranks log-probabilities: sampling knobs
                # cannot be honoured
                raise ValueError(
                    "num_beams > 1 is greedy-scored; do_sample cannot be "
                    "honored — use num_beams=1 for sampling"
                )
            if max_new_tokens is not None:
                gen = dataclasses.replace(gen, max_new_tokens=max_new_tokens)
            if isinstance(prompts, str):
                prompts = [prompts]
            return generate_with_beams(
                self.engine, prompts, gen,
                eos_token_id=self.rm.eos_token_id, tokenizer=self.tokenizer,
            )
        return self.rm.generate(prompts, gen, max_new_tokens)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
