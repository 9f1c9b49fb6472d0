"""Quantized paged KV cache — write-side math and layout registry.

Counterpart of ``flexflow_tpu/serve/kv_quant.py``. A quantized page pool
stores, per cache tensor (K and V) and layer, ``(P+1, page_size, KV,
dk/pack)`` codes (int8: one code per byte; int4: two nibble codes per
byte along dk) and ``(P+1, KV)`` float32 scales — one symmetric amax
scale per page per KV head. Attention dequantizes at read time
(serve/kernels.py).

Write-side contract (:func:`quant_line_write`), unchanged from the JAX
package:

1. each page's scale is the running amax (per KV head) of every line
   committed to it, divided by qmax;
2. when a new line grows the scale, the page's codes are requantized
   (``round(code * s_old / s_new)``); an unchanged scale gives a ratio
   of exactly 1.0, a bitwise identity;
3. a write at in-page offset 0 resets the page's scale, so page content
   is a function of the tokens written, never of allocation history.

int4 (``SPECS["int4"]``, qmax 7, pack 2): byte ``j`` of a line holds
code ``j`` in its low nibble and code ``j + dk/2`` in its high nibble,
each biased by +8.

Differences from the JAX package: :func:`quant_line_write` updates the
pool and scale tensors **in place** (the JAX function returns new
arrays), and every division that decides a code is tensor by tensor, so
that CUDA computes it as an IEEE division rather than as a product with
the divisor's reciprocal. :func:`quant_commit_lines` (the SpecInfer KV
move) writes through ``kernels.commit_paged``, so CUDA pools take the
commit kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """One quantized-KV storage layout (see the module docstring)."""

    name: str
    bits: int
    qmax: float            # symmetric clip: codes live in [-qmax, qmax]
    dtype: torch.dtype     # storage dtype of the page pool
    pack: int = 1          # codes per storage element (int4 packs 2 along dk)

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()


SPECS = {
    "int8": KVQuantSpec("int8", 8, 127.0, torch.int8, 1),
    # packed nibbles along dk; uint8 storage is the pack=2 discriminator
    "int4": KVQuantSpec("int4", 4, 7.0, torch.uint8, 2),
}


def resolve_spec(kv_quant: Optional[str]) -> Optional[KVQuantSpec]:
    """Validate a ``ServingConfig.kv_quant`` value. None passes through;
    unknown names are a ValueError."""
    if kv_quant is None:
        return None
    spec = SPECS.get(kv_quant)
    if spec is None:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r} (expected one of "
            f"{sorted(SPECS)} or None)"
        )
    return spec


# ---------------------------------------------------------------------------
# nibble packing (pack=2 layouts): integer adds, shifts and masks only


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(..., dk) signed codes in [-8, 7] → (..., dk//2) uint8: byte j
    holds code j (low nibble) and code j + dk/2 (high nibble), each
    biased +8."""
    dk = codes.shape[-1]
    c = codes.to(torch.int32) + 8
    lo, hi = c[..., : dk // 2], c[..., dk // 2:]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., dkp) uint8 → (..., 2*dkp) f32 signed codes (the inverse of
    :func:`pack_nibbles`; an all-zero byte decodes to -8, which a zero
    page scale maps to 0.0)."""
    b = packed.to(torch.int32)
    lo = (b & 0xF) - 8
    hi = ((b >> 4) & 0xF) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.float32)


def pool_pack(pool: torch.Tensor) -> int:
    """Codes per storage element of a quantized page pool: uint8 is the
    packed-nibble layout, int8 stores one code per byte."""
    return 2 if pool.dtype == torch.uint8 else 1


def unpack_codes(stored: torch.Tensor, pack: int) -> torch.Tensor:
    """Stored codes → f32 code values: a cast for int8 (pack 1), the
    nibble unpack for int4 (pack 2)."""
    return unpack_nibbles(stored) if pack == 2 else stored.to(torch.float32)


def pack_codes(codes: torch.Tensor, dtype: torch.dtype, pack: int) -> torch.Tensor:
    """f32 code values → stored codes (the inverse of :func:`unpack_codes`)."""
    return pack_nibbles(codes) if pack == 2 else codes.to(dtype)


def quant_line_write(
    kq: torch.Tensor,     # (P+1, ps, KV, dk/pack) quantized page pool (one layer)
    scale: torch.Tensor,  # (P+1, KV) f32 per-page-per-head scales
    phys: torch.Tensor,   # (R, C) int physical page per new line
    off: torch.Tensor,    # (R, C) int in-page offset per new line
    vals: torch.Tensor,   # (R, C, KV, dk) full-precision lines to commit
    qmax: float,
):
    """Commit full-precision K/V lines into a quantized page pool, in
    place (the quantized twin of ``pool[phys, off] = vals``): running
    per-page amax scales, rescale-on-growth, offset-0 scale reset. The
    arithmetic and both of its branches (per-line page gather below
    ``R*C < P+1``, the full pool above) are the JAX function's. Returns
    ``(kq, scale)``, the tensors passed in."""
    P1 = kq.shape[0]
    dkp = kq.shape[-1]
    R, C = phys.shape
    pack = vals.shape[-1] // dkp
    phys = phys.long()
    off = off.long()
    vf = vals.to(torch.float32)
    amax = vf.abs().amax(dim=-1)                                  # (R, C, KV)
    KV = amax.shape[-1]
    flat = phys.reshape(-1)

    # offset-0 writes mark the page's first use by its current owner
    first = torch.zeros((P1,), dtype=torch.int32, device=kq.device)
    first.scatter_reduce_(0, flat, (off.reshape(-1) == 0).to(torch.int32), "amax")
    old = torch.where(first[:, None] > 0, torch.zeros_like(scale), scale)
    line_scale = amax / torch.full_like(amax, qmax)               # IEEE division
    new = old.clone()
    new.scatter_reduce_(0, flat[:, None].expand(-1, KV),
                        line_scale.reshape(-1, KV), "amax")

    def ratio_of(o, n):
        return torch.where(n > 0.0, o / n.clamp_min(1e-30), torch.zeros_like(n))

    if R * C < P1:
        ratio = ratio_of(old[flat], new[flat])                    # (R*C, KV)
        content = unpack_codes(kq[flat], pack)                    # (R*C, ps, KV, dk)
        requant = torch.round(content * ratio[:, None, :, None])
        kq[flat] = pack_codes(requant, kq.dtype, pack)
    else:
        ratio = ratio_of(old, new)                                # (P1, KV)
        requant = torch.round(unpack_codes(kq, pack) * ratio[:, None, :, None])
        kq.copy_(pack_codes(requant, kq.dtype, pack))

    # quantize the new lines at their page's (final) scale and scatter
    s_line = new[phys]                                            # (R, C, KV)
    q = torch.round(vf / s_line[..., None].clamp_min(1e-30))
    q = q.clamp(-qmax, qmax)
    kq[phys, off] = pack_codes(q, kq.dtype, pack)
    scale.copy_(new)
    return kq, scale


def quant_commit_lines(
    k_pool: torch.Tensor,   # (L, P+1, ps, KV, dk/pack) quantized pools
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (L, P+1, KV) f32
    v_scale: torch.Tensor,
    s_phys: torch.Tensor,   # (R, K) source physical pages
    s_off: torch.Tensor,    # (R, K) source in-page offsets
    d_phys: torch.Tensor,   # (R, K) destination physical pages
    d_off: torch.Tensor,    # (R, K) destination in-page offsets
    qmax: float,
    *,
    kernels: str = "cuda",
) -> None:
    """Move quantized K/V lines between table-resolved positions, in
    place (the SpecInfer KV commit, ``models/llama.commit_kv_paged``):
    codes cannot move verbatim, since source and destination pages carry
    different scales, so each layer's source lines are dequantized at
    their page scales (int4 nibbles unpacked) and committed again through
    ``kernels.commit_paged`` — ``quant_line_write``'s arithmetic, the
    commit kernel on CUDA tensors with ``kernels="cuda"``. A layer's K
    and V source lines are all read before its first write: a
    destination page may hold another request's source lines."""
    from .kernels import commit_paged

    s_phys, s_off = s_phys.long(), s_off.long()
    pack = pool_pack(k_pool)
    for l in range(k_pool.shape[0]):
        rows = []
        for pool, scale in ((k_pool[l], k_scale[l]), (v_pool[l], v_scale[l])):
            codes = unpack_codes(pool[s_phys, s_off], pack)        # (R, K, KV, dk)
            rows.append(codes * scale[s_phys][..., None])          # at the source scale
        commit_paged(k_pool[l], v_pool[l], rows[0], rows[1], d_phys.long(), d_off.long(),
                     k_scale[l], v_scale[l], qmax, kernels=kernels)


def page_bytes(page_size: int, kv_heads: int, head_dim: int, itemsize: int,
               *, scale_heads: int = 0) -> int:
    """K+V bytes one physical page costs per layer: two pools of
    ``page_size × kv_heads × head_dim`` elements plus (quantized
    layouts) two f32 scale rows of ``scale_heads`` entries."""
    return 2 * (page_size * kv_heads * head_dim * itemsize + 4 * scale_heads)


def quantized_pool_pages(fp_pages: int, page_size: int, kv_heads: int,
                         head_dim: int, fp_itemsize: int,
                         spec: KVQuantSpec) -> int:
    """The number of quantized pages the HBM budget of ``fp_pages``
    full-precision pages buys (``ServingConfig.max_cached_tokens`` keeps
    meaning "this much KV memory" with ``kv_quant`` on)."""
    budget = fp_pages * page_bytes(page_size, kv_heads, head_dim, fp_itemsize)
    qpage = page_bytes(page_size, kv_heads, -(-head_dim // spec.pack),
                       spec.itemsize, scale_heads=kv_heads)
    return max(fp_pages, budget // qpage)
