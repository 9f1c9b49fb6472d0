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
``compile(output_file=)`` appends one record a finished request (the
reference's ``-output-file``); triage and tracing are
``ServingConfig.inference_debugging`` and ``obs.attach_observability(llm.rm)``.

``compile(quantization="int8"|"int4")`` quantizes the layer matmul
weights (quantization.py; their products run ``kernels.wq_matmul``) and
``compile(offload=True)`` keeps every per-layer tensor in pinned host
memory on a GPU, streamed to the device a layer at a time
(``quantization.OffloadedLayers``; the embedding, the LM head and the
final norm stay on the device); both apply to SpecInfer's SSMs too.
``ServingConfig(replicas > 1)`` or prefill/decode pools make ``compile``
build an in-process :class:`~.cluster.ClusterManager` (``llm.rm``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .. import models as zoo
from ..logging_utils import get_logger
from ..models import hf_utils
from ..quantization import OffloadedLayers, quantize_params
from .batch_config import GenerationConfig, GenerationResult
from .engine import InferenceEngine, ServingConfig, resolve_device
from .request_manager import RequestManager
from .specinfer import SpecConfig, SpecInferManager

#: files of a tokenizer in an HF checkpoint directory
TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")

def detect_family(hf_config: Dict[str, Any]):
    """The model-family module of an HF config (``models.FAMILIES``, the
    JAX package's thirteen keys): by ``model_type``, else by
    ``architectures`` (longest family name first). An unknown family
    raises ValueError."""
    mt = hf_config.get("model_type", "")
    if mt in zoo.FAMILIES:
        return zoo.FAMILIES[mt]
    for arch in hf_config.get("architectures", []):
        for k in sorted(zoo.FAMILIES, key=len, reverse=True):
            if k.replace("_", "") in arch.lower().replace("_", ""):
                return zoo.FAMILIES[k]
    raise ValueError(f"unsupported model family: {mt!r} / "
                     f"{hf_config.get('architectures')}")


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
        quantization: Optional[str] = None,
        offload: bool = False,
        output_file: Optional[str] = None,
    ) -> None:
        """Build the inference engine(s) and request manager (reference
        ``LLM.compile``). Params move to the LLM's device here. With
        ``ssms`` (or ``spec.draft == "early_exit"``) the manager runs the
        SpecInfer loop; each SSM gets an engine on this LLM's device with
        the same ``serving``. ``output_file`` appends each finished
        request's latency, decoding steps and token ids.

        ``quantization`` ("int8" | "int4") converts the layer matmul
        weights to ``{"q", "scale"}`` pairs before placement (the
        reference's quantized loading). ``offload`` keeps every
        ``params["layers"]`` tensor in pinned host memory on a GPU and
        streams it a layer at a time (the reference's ``--offload``); on
        the CPU it warns and does nothing. ``serving.replicas > 1`` or
        prefill/decode pools build an in-process cluster
        (:class:`~.cluster.ClusterManager`, params shared by reference
        among the replicas); ``self.engine`` is then replica 0's."""
        serving = serving or ServingConfig()
        serving.validate()
        speculating = bool(ssms) or getattr(spec, "draft", "ssm") == "early_exit"
        serving.validate_cluster(specinfer=speculating)
        if quantization not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantization {quantization!r} (expected 'int8' or "
                             "'int4')")
        self.params = _place_params(self.params, self.device, quantization, offload)
        for ssm in ssms:
            ssm.params = _place_params(ssm.params, self.device, quantization, offload)
        if serving.replicas > 1 or serving.prefill_replicas:
            from .cluster import ClusterManager

            self.rm = ClusterManager.build(
                self.family, self.cfg, self.params, serving, tokenizer=self.tokenizer,
                eos_token_id=eos_token_id, seed=seed, device=self.device,
                ssms=[(s.family, s.cfg, s.params) for s in ssms], spec=spec)
            self.engine = self.rm.replicas[0].engine
            return
        self.engine = InferenceEngine(
            self.family, self.cfg, self.params, serving, device=self.device
        )
        if speculating:
            for ssm in ssms:
                ssm.engine = InferenceEngine(ssm.family, ssm.cfg, ssm.params, serving,
                                             device=self.device)
            self.rm = SpecInferManager(
                self.engine, [s.engine for s in ssms], spec,
                tokenizer=self.tokenizer, eos_token_id=eos_token_id, seed=seed,
                output_file=output_file,
            )
            return
        self.rm = RequestManager(
            self.engine,
            tokenizer=self.tokenizer,
            eos_token_id=eos_token_id,
            seed=seed,
            output_file=output_file,
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


def _place_params(params: Dict[str, Any], device: torch.device,
                  quantization: Optional[str], offload: bool) -> Dict[str, Any]:
    """Quantize (optionally) and place params: on ``device``, or with
    ``offload`` on a GPU the layers in pinned host memory
    (:class:`~..quantization.OffloadedLayers`) and the rest on the device."""
    if quantization is not None:
        params = quantize_params(params, {"int8": 8, "int4": 4}[quantization])
    if offload and device.type == "cuda":
        if isinstance(params["layers"], OffloadedLayers):
            return params
        placed = _to_device({k: v for k, v in params.items() if k != "layers"}, device)
        placed["layers"] = OffloadedLayers(params["layers"], device)
        return placed
    if offload:
        warnings.warn(f"offload=True has no effect on {device.type} (params already live "
                      "in host memory there)", stacklevel=3)
    return _to_device(params, device)
