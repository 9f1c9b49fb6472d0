"""High-level ``LLM`` serving API.

Counterpart of ``flexflow_tpu/serve/llm.py``: a servable causal LM from a
local HF checkpoint directory (:meth:`LLM.from_pretrained`) or from
in-memory (family, cfg, params) — random weights from ``seed`` when no
params are given — compiled into an :class:`InferenceEngine` plus a
:class:`RequestManager`, with a blocking ``generate`` and a streaming
``rm.generate_stream``. ``compile(ssms=, spec=)`` serves SpecInfer
(serve/specinfer.py): each SSM ``LLM`` gets an engine with the same
``ServingConfig`` and the manager becomes a :class:`SpecInferManager`;
``SpecConfig(draft="early_exit")`` without SSMs self-speculates.
``generate`` with ``num_beams > 1`` beam-searches (serve/beam.py).

Weight quantization, offload and clusters come with later slices of the
port.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .. import models as zoo
from ..logging_utils import get_logger
from ..models import hf_utils
from .batch_config import GenerationConfig, GenerationResult
from .engine import InferenceEngine, ServingConfig, resolve_device
from .request_manager import RequestManager
from .specinfer import SpecConfig, SpecInferManager

#: files of a tokenizer in an HF checkpoint directory
TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")

#: the JAX package's model families (flexflow_tpu/models FAMILIES keys)
#: that the port has not ported yet: they come with ROADMAP.md queue 1
#: item 4 (the generic decoder and the other families)
LATER_FAMILIES = ("opt", "falcon", "mpt", "starcoder", "gpt_bigcode", "qwen2", "mixtral",
                  "mistral", "qwen2_moe", "gemma", "phi", "gpt2")


def detect_family(hf_config: Dict[str, Any]):
    """The model-family module of an HF config: by ``model_type``, else by
    ``architectures`` (longest family name first). A family of the JAX
    package that the port lacks raises NotImplementedError; an unknown
    one ValueError."""
    mt = hf_config.get("model_type", "")
    known = {**{k: None for k in LATER_FAMILIES}, **zoo.FAMILIES}
    key = mt if mt in known else None
    if key is None:
        for arch in hf_config.get("architectures", []):
            for k in sorted(known, key=len, reverse=True):
                if k.replace("_", "") in arch.lower().replace("_", ""):
                    key = k
                    break
            if key is not None:
                break
    if key is None:
        raise ValueError(f"unsupported model family: {mt!r} / "
                         f"{hf_config.get('architectures')}")
    if key not in zoo.FAMILIES:
        raise NotImplementedError(
            f"model family {key!r} is not ported yet: it comes with ROADMAP.md queue 1 "
            "item 4 (the generic decoder and the eleven other families)")
    return zoo.FAMILIES[key]


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

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        *,
        dtype: torch.dtype = torch.bfloat16,
        tokenizer: Any = "auto",
        device: Any = None,
        **cfg_overrides,
    ) -> "LLM":
        """Load config and weights from a local HF checkpoint directory
        (``config.json``; ``*.safetensors`` or ``pytorch_model*.bin``,
        models/hf_utils.py) onto ``device`` (``"cuda"`` unless the caller
        names another; raises without a GPU before reading anything), the
        weights in ``dtype``. ``tokenizer="auto"`` loads the directory's
        tokenizer through ``transformers.AutoTokenizer`` with
        ``local_files_only=True`` where the directory holds tokenizer files
        (``TOKENIZER_FILES``) and ``transformers`` is installed, and is None
        otherwise or where that fails (prompts are then token ids)."""
        dev = resolve_device(device)
        hf_cfg = hf_utils.load_hf_config(model_dir)
        family = detect_family(hf_cfg)
        cfg = family.from_hf(hf_cfg, dtype=dtype, **cfg_overrides)
        params = family.convert_hf_state_dict(hf_utils.load_state_dict(model_dir), cfg,
                                              device=dev)
        if tokenizer == "auto":
            tokenizer = None
            if (any(os.path.exists(os.path.join(model_dir, f)) for f in TOKENIZER_FILES)
                    and importlib.util.find_spec("transformers") is not None):
                try:
                    from transformers import AutoTokenizer

                    tokenizer = AutoTokenizer.from_pretrained(model_dir,
                                                              local_files_only=True)
                except Exception as e:  # an unreadable tokenizer: serve token ids
                    get_logger("serve").info("no tokenizer in %s: %s", model_dir, e)
                    tokenizer = None
        return cls(family, cfg, params, tokenizer=tokenizer, device=dev)

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


class SSM(LLM):
    """A small speculative model (reference ``serve.py`` SSM): the same
    object as :class:`LLM`, served beside it by ``LLM.compile(ssms=[...])``
    on the LLM's device."""


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
