"""Weight-only int8/int4 quantization, and parameter offload.

Counterpart of ``flexflow_tpu/quantization.py`` (the reference's
quantized serving path: int4/int8 dequantize kernels and the
``--4bit/8bit-quantization`` flags). Weights quantize **per output
channel** with a symmetric scale (``q = round(w / s)``, ``s = max|w| /
qmax`` over the input dim, rounded half to even), stored as a ``{"q",
"scale"}`` dict in place of the dense tensor; int4 packs two codes a byte
along the input dim (low nibble = even row), biased to [0, 15] around 8.
The layout is the JAX package's at every public function, so codes and
scales compare bitwise.

The matmul of a quantized weight is ``serve/kernels.wq_matmul``: on the
CPU the plain version (:func:`dequantize`, then the product), on the GPU
a hand-written kernel that dequantizes inside the product
(``csrc/wq_matmul.cu``), so no bf16 copy of a weight is ever written.

Offload (``LLM.compile(offload=True)`` on a GPU): :class:`OffloadedLayers`
keeps every per-layer tensor in pinned host memory and copies layer l + 1
into one of two device buffers on a copy stream while layer l computes.
Every per-layer loop takes its layer through :func:`layer_params`, which
slices quantized pairs too and hands out the device copy of an offloaded
layer.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

INT8_MAX = 127.0
INT4_MAX = 7.0

#: the whole step's refusal of offloaded params (models' whole_step_weight_layout)
OFFLOAD_WHOLE_STEP = (
    "whole_step is not composed with offloaded params: its one persistent kernel "
    "reads every layer's weights in one launch, and offloaded layers reach the "
    "device one at a time — serve offloaded params without the whole_step fusion")


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def quantize_tensor(w: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    """Quantize a (..., in, out) weight per output channel over the input
    dim: ``{"q": int8 (..., in, out) | uint8 (..., in // 2, out), "scale":
    f32 (..., 1, out)}``. int4 needs an even input dim."""
    assert bits in (4, 8), bits
    wf = w.to(torch.float32)
    qmax = INT8_MAX if bits == 8 else INT4_MAX
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    # a tensor divisor: CUDA's tensor / python float multiplies by the
    # reciprocal, which is not the JAX package's division
    scale = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-12)
    q = torch.round(wf / scale)  # half to even, as jnp.round
    if bits == 8:
        q = torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        if w.shape[-2] % 2:
            raise ValueError(f"int4 packing needs an even input dim, got {tuple(w.shape)}")
        qb = (torch.clamp(q, -INT4_MAX, INT4_MAX) + 8).to(torch.uint8)
        q = qb[..., 0::2, :] | (qb[..., 1::2, :] << 4)  # (..., in // 2, out)
    return {"q": q.contiguous(), "scale": scale}


def unpack_weight_codes(q: torch.Tensor) -> torch.Tensor:
    """The signed codes of a quantized weight as int32 (..., in, out):
    int8 as they are, packed int4 nibble pairs re-interleaved."""
    if q.dtype == torch.int8:
        return q.to(torch.int32)
    lo = (q & 0xF).to(torch.int32) - 8
    hi = ((q >> 4) & 0xF).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-2).reshape(*q.shape[:-2], q.shape[-2] * 2, q.shape[-1])


def dequantize(qw: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``{"q", "scale"}`` → the dense (..., in, out) weight in ``dtype``:
    the f32 code times the f32 scale, cast once. The bit width is the
    storage dtype's: int8 codes, or uint8 int4 nibble pairs."""
    return (unpack_weight_codes(qw["q"]).to(torch.float32) * qw["scale"]).to(dtype)


def _leaf_names(layers: Dict[str, Any]) -> List[str]:
    """The quantizable stacked-layer weights: 3-D matmul kernels and 4-D
    expert stacks (L, E, in, out) whose names start with ``w``; norms and
    biases stay dense, and so does the MoE router (a tiny matmul whose
    rounding would move top-k expert selection)."""
    return [k for k, v in layers.items()
            if k.startswith("w") and hasattr(v, "ndim") and v.ndim in (3, 4)
            and k != "w_router"]


def quantize_params(params: Dict[str, Any], bits: int) -> Dict[str, Any]:
    """Quantize a model family's layer matmul weights (``_leaf_names``);
    the embedding, the LM head, the norms and the biases stay dense."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _leaf_names(layers):
        layers[name] = quantize_tensor(layers[name], bits)
    out["layers"] = layers
    return out


def quantized_nbytes(params: Any) -> int:
    """Bytes of every tensor in the param tree (footprint checks)."""
    if isinstance(params, dict):
        return sum(quantized_nbytes(v) for v in params.values())
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0


def _slice(w: Any, l: int):
    if isinstance(w, dict):
        return {k: v[l] for k, v in w.items()}
    return w[l]


def layer_params(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s tensors ``{name: w[l]}`` (a quantized pair sliced as
    ``{"q": q[l], "scale": scale[l]}``); of :class:`OffloadedLayers`, the
    device copy of the layer."""
    if isinstance(layers, OffloadedLayers):
        return layers.layer(l)
    return {name: _slice(w, l) for name, w in layers.items()}


def _map(w: Any, fn):
    if isinstance(w, dict):
        return {k: fn(v) for k, v in w.items()}
    return fn(w)


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


class OffloadedLayers(dict):
    """``params["layers"]`` with every tensor in pinned host memory,
    streamed to ``device`` a layer at a time (the reference's ``--offload``
    zero-copy double buffering; the JAX package places the params in
    ``pinned_host`` memory and leaves the streaming to XLA).

    :meth:`layer` returns layer l's tensors in one of two device buffers.
    The copies run on a stream of their own: each one first waits for
    everything enqueued on the compute stream so far (the last reader of
    the buffer it overwrites), and the compute stream waits for the copy's
    event before it reads. Serving layer l starts the copy of layer l + 1
    (layer 0 after the last), so the copy overlaps layer l's compute. The
    bytes the kernels read are the bytes of the non-offloaded params:
    offloaded serving is bitwise the same configuration's."""

    offloaded = True

    def __init__(self, layers: Dict[str, Any], device: torch.device):
        super().__init__({name: _map(w, _pinned) for name, w in layers.items()})
        self.device = torch.device(device)
        first = next(iter(self.values()))
        self.num_layers = int((first["q"] if isinstance(first, dict) else first).shape[0])
        self._bufs = [{name: _map(w, lambda t: torch.empty(t.shape[1:], dtype=t.dtype,
                                                            device=self.device))
                       for name, w in self.items()} for _ in range(2)]
        self._holds = [-1, -1]
        self._last = 1
        self._stream = torch.cuda.Stream(self.device)
        self._ready = [torch.cuda.Event(), torch.cuda.Event()]
        #: host-to-device layer copies started (prefetches included)
        self.copies = 0

    def _copy(self, l: int, b: int, compute) -> None:
        self._stream.wait_stream(compute)
        with torch.cuda.stream(self._stream):
            for name, w in self.items():
                dst = self._bufs[b][name]
                if isinstance(w, dict):
                    for k, v in w.items():
                        dst[k].copy_(v[l], non_blocking=True)
                else:
                    dst.copy_(w[l], non_blocking=True)
            self._ready[b].record(self._stream)
        self._holds[b] = l
        self.copies += 1

    def layer(self, l: int) -> Dict[str, Any]:
        compute = torch.cuda.current_stream(self.device)
        b = self._holds.index(l) if l in self._holds else None
        if b is None:
            b = 1 - self._last
            self._copy(l, b, compute)
        compute.wait_event(self._ready[b])
        self._last = b
        nxt = (l + 1) % self.num_layers
        if self.num_layers > 1 and self._holds[1 - b] != nxt:
            self._copy(nxt, 1 - b, compute)
        return self._bufs[b]
