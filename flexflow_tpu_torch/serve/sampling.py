"""Decode heads: greedy argmax, temperature, top-k, top-p sampling.

Counterpart of ``flexflow_tpu/serve/sampling.py``: one function handles
a whole batch with per-request parameters as tensors, so mixed
greedy/sampling batches run together, and the head is specialized by
``mode`` to what the batch needs (chosen host-side by
:func:`choose_sample_mode`):

``"greedy"``
    every row argmaxes — no scaling, no filters, no sort, no draw.
``"sample"``
    temperature-only sampling (top-k/top-p both disabled) — no sort.
``"topk"``
    per-row top-k (no top-p): the k-th value comes from one top-k over a
    power-of-two ``topk_cap`` bucket instead of the full sort.
``"full"``
    one shared descending sort feeds both filters.

:func:`log_softmax` and :func:`beam_topk` are the heads of SpecInfer's
tree expansion and of beam search.

The categorical draw takes its noise from a ``torch.Generator``; it
cannot reproduce ``jax.random``'s bits, so parity with the JAX package
holds for the filtered logits and for greedy tokens, not for drawn ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30

#: largest per-row top-k the bucketed "topk" mode serves; bigger ks use
#: the full-sort head
TOPK_CAP_LIMIT = 128


def choose_sample_mode(
    greedy: np.ndarray,   # (R,) bool
    topp: np.ndarray,     # (R,) float; >= 1 disables
    topk: np.ndarray,     # (R,) int; <= 0 disables
    vocab_size: int,
) -> Tuple[str, int]:
    """Pick the cheapest head mode serving this batch's decode-head
    arrays. Returns ``(mode, topk_cap)``; ``topk_cap`` is 0 except for
    the bucketed "topk" mode."""
    greedy = np.asarray(greedy, bool)
    if bool(greedy.all()):
        return "greedy", 0
    sampling = ~greedy
    if bool((np.asarray(topp, np.float32)[sampling] < 1.0).any()):
        return "full", 0
    mk = int(np.asarray(topk, np.int64)[sampling].max(initial=0))
    if mk <= 0:
        return "sample", 0
    if mk >= min(TOPK_CAP_LIMIT, vocab_size):
        return "full", 0
    cap = 1 << (mk - 1).bit_length()  # smallest power of two >= mk
    return "topk", min(cap, vocab_size)


def _apply_topk(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Static-k top-k filter: keep the k largest logits per row."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _sorted_desc(logits: torch.Tensor) -> torch.Tensor:
    """One full descending sort — the shared tensor both filters cut."""
    return torch.sort(logits, dim=-1, descending=True).values


def _topk_filter(
    logits: torch.Tensor,
    topk: torch.Tensor,
    sorted_desc: Optional[torch.Tensor] = None,
):
    """Per-row top-k filter (``topk`` (R,) int; <= 0 disables for that
    row). Returns ``(filtered, filtered_sorted)``: the filter drops a
    suffix of the descending sort, so the filtered tensor's sort is the
    shared sort with that suffix set to NEG_INF (the top-p filter
    consumes it)."""
    V = logits.shape[-1]
    if sorted_desc is None:
        sorted_desc = _sorted_desc(logits)
    kk = torch.clamp(topk.long(), 1, V)
    kth = torch.gather(sorted_desc, -1, (kk - 1)[..., None])
    keep_all = (topk <= 0)[..., None]
    filtered = torch.where(keep_all | (logits >= kth), logits, NEG_INF)
    filtered_sorted = torch.where(
        keep_all | (sorted_desc >= kth), sorted_desc, NEG_INF
    )
    return filtered, filtered_sorted


def _topp_filter(
    logits: torch.Tensor,
    topp: torch.Tensor,
    sorted_desc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Top-p (nucleus) filter — sorted cumulative-probability cut.
    ``topp`` is per-row (R,); topp >= 1 keeps everything."""
    if sorted_desc is None:
        sorted_desc = _sorted_desc(logits)
    sorted_probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    # Keep tokens while the cumulative mass *before* them is < topp.
    keep_sorted = (cum - sorted_probs) < topp[..., None]
    # Threshold logit: smallest kept logit per row.
    thresh = torch.where(keep_sorted, sorted_desc, torch.inf).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < thresh, NEG_INF, logits)


def filter_logits(
    logits: torch.Tensor,
    *,
    temperature: torch.Tensor,
    topp: torch.Tensor,
    topk: int = 0,
    topk_arr: Optional[torch.Tensor] = None,
    mode: str = "full",
    topk_cap: int = 0,
) -> torch.Tensor:
    """The filtered, temperature-scaled logits the categorical draw of a
    non-greedy ``mode`` samples from (NEG_INF where filtered out)."""
    logits = logits.to(torch.float32)
    t = torch.clamp(temperature, min=1e-6)[..., None]
    scaled = _apply_topk(logits / t, topk)
    if mode == "sample":
        return scaled  # temperature only: both filters are identity
    if mode == "topk":
        V = scaled.shape[-1]
        top = torch.topk(scaled, topk_cap, dim=-1).values  # (R, cap)
        kk = torch.clamp(topk_arr.long(), 1, V)
        kth = torch.gather(top, -1, (kk - 1)[..., None])
        keep_all = (topk_arr <= 0)[..., None]
        return torch.where(keep_all | (scaled >= kth), scaled, NEG_INF)
    # "full" — one shared sort feeds both filters
    sorted_desc = _sorted_desc(scaled)
    if topk_arr is not None:
        scaled, sorted_desc = _topk_filter(scaled, topk_arr, sorted_desc)
    return _topp_filter(scaled, topp, sorted_desc)


def sample_tokens(
    logits: torch.Tensor,          # (R, V) float
    generator: Optional[torch.Generator],
    *,
    greedy: torch.Tensor,          # (R,) bool — argmax instead of sampling
    temperature: torch.Tensor,     # (R,) float
    topp: torch.Tensor,            # (R,) float; >= 1 disables
    topk: int = 0,                 # static; 0 disables
    topk_arr: Optional[torch.Tensor] = None,  # (R,) int; <= 0 disables per row
    mode: str = "full",
    topk_cap: int = 0,
) -> torch.Tensor:
    """Sample one token per request slot. Returns (R,) int64 on the
    logits' device. ``mode``/``topk_cap`` come from
    :func:`choose_sample_mode`, which is the contract: a mode the batch's
    arrays do not satisfy serves the wrong head."""
    logits = logits.to(torch.float32)
    greedy_tok = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return greedy_tok
    scaled = filter_logits(
        logits, temperature=temperature, topp=topp, topk=topk,
        topk_arr=topk_arr, mode=mode, topk_cap=topk_cap,
    )
    # Gumbel-max categorical draw (the same construction as
    # jax.random.categorical, with torch's noise)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(greedy, greedy_tok, sampled)


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Log-probabilities over the last dim, in float32."""
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def beam_topk(logprobs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim, largest first — the beam expansion head
    (reference ``beam_topk.cc``). Returns (values, indices), each
    (..., k)."""
    return torch.topk(logprobs, k, dim=-1)
