from . import (falcon, gemma, gpt2, hf_utils, llama, mistral, mixtral, mpt, opt, phi, qwen2,
               qwen2_moe, starcoder, transformer)

# Model-family registry (flexflow_tpu/models/__init__.py FAMILIES): the
# keys are HF model types
FAMILIES = {
    "llama": llama,
    "opt": opt,
    "falcon": falcon,
    "mpt": mpt,
    "starcoder": starcoder,
    "gpt_bigcode": starcoder,
    "qwen2": qwen2,
    "mixtral": mixtral,
    "mistral": mistral,
    "qwen2_moe": qwen2_moe,
    "gemma": gemma,
    "phi": phi,
    "gpt2": gpt2,
}

__all__ = [
    "llama", "transformer", "opt", "falcon", "mpt", "starcoder", "qwen2", "mixtral",
    "mistral", "qwen2_moe", "gemma", "phi", "gpt2", "hf_utils", "FAMILIES",
]
