"""Local HuggingFace checkpoints: the config and the state dict.

Counterpart of ``flexflow_tpu/models/hf_utils.py``. A checkpoint
directory holds ``config.json`` and its weights as ``*.safetensors`` (one
file or several shards) or, failing those, ``pytorch_model*.bin``. The
safetensors files are read here, with no ``safetensors`` package: an
8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw bytes. The family modules map
the state dict into their parameter trees (``convert_hf_state_dict``).
Nothing is downloaded: the directory must be local.

The converters' helpers (:func:`linear_w`, :func:`stack`,
:func:`layer_stackers`) take the state dict's torch tensors as they are;
:func:`params_from_numpy` carries a parameter tree given as numpy arrays
(the JAX package's ``init_params`` output, in the tests) across to torch.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: safetensors dtype names and the torch dtypes they read as
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_hf_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors of the
    file's dtypes (one read per tensor into its own buffer)."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, entry in header.items():
            if name == "__metadata__":
                continue
            dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}, "
                                 f"not one of {sorted(SAFETENSORS_DTYPES)}")
            begin, end = entry["data_offsets"]
            shape = tuple(entry["shape"])
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
            if len(buf) != end - begin:
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(shape)
    return out


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """All weights of a local HF checkpoint directory as CPU tensors:
    ``*.safetensors`` (read by :func:`read_safetensors`, every shard),
    else ``pytorch_model*.bin`` through ``torch.load(weights_only=True)``."""
    names = sorted(os.listdir(model_dir))
    sd: Dict[str, torch.Tensor] = {}
    st_files = [f for f in names if f.endswith(".safetensors")]
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(os.path.join(model_dir, f)))
        return sd
    bin_files = [f for f in names if f.startswith("pytorch_model") and f.endswith(".bin")]
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")
    for f in bin_files:
        sd.update(torch.load(os.path.join(model_dir, f), map_location="cpu",
                             weights_only=True))
    return sd


# ---------------------------------------------------------------------------
# Converter helpers shared by the family modules


def linear_w(sd: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """An HF ``nn.Linear`` weight, stored (out, in), as the (in, out)
    matrix the port right-multiplies by (a transposed view)."""
    return sd[name].t()


def stack(tensors: List[torch.Tensor], dtype: torch.dtype, device: Any) -> torch.Tensor:
    """One (L, ...) tensor of ``dtype`` on ``device`` from L per-layer
    tensors of one shape, filled a layer at a time (one layer's copy on the
    host at most)."""
    out = torch.empty((len(tensors),) + tuple(tensors[0].shape), dtype=dtype, device=device)
    for i, t in enumerate(tensors):
        out[i].copy_(t)
    return out


def layer_stackers(sd: Dict[str, torch.Tensor], pre: str, num_layers: int,
                   dtype: torch.dtype, device: Any):
    """(mats, vecs): stack a per-layer HF tensor name pattern (``fmt`` with
    one ``{}`` for the layer) into one (L, ...) tensor; ``mats`` transposes
    Linear weights to (in, out), ``vecs`` takes them as they are."""

    def mats(fmt):
        return stack([linear_w(sd, pre + fmt.format(i)) for i in range(num_layers)], dtype,
                     device)

    def vecs(fmt):
        return stack([sd[pre + fmt.format(i)] for i in range(num_layers)], dtype, device)

    return mats, vecs


def put(t: torch.Tensor, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """One tensor in ``dtype`` on ``device``, contiguous."""
    return t.to(device=device, dtype=dtype).contiguous()


# ---------------------------------------------------------------------------
# The weight bridge from numpy trees


def _array_to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # torch wants writable memory
    # JAX bf16 arrays reach numpy as ml_dtypes.bfloat16, which
    # torch.from_numpy refuses: reinterpret the bits through uint16.
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, *, device: Any,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Carry a parameter tree given as numpy arrays (nested dicts: the JAX
    package's ``init_params`` of any family, the generic decoder's (L, E,
    D, F) expert stacks and shared-expert tensors included) across to the
    port's params on ``device``. Keys and layouts are unchanged; ``dtype``
    casts every leaf when given."""
    if isinstance(tree, dict):
        return {
            k: params_from_numpy(v, device=device, dtype=dtype)
            for k, v in tree.items()
        }
    t = _array_to_tensor(np.asarray(tree))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)
