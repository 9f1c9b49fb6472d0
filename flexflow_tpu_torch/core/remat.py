"""Named rematerialisation policies — the port of
``flexflow_tpu/core/remat.py``.

``None`` is full per-block remat (save only block boundaries); "dots"
saves the matmul outputs and recomputes just the cheap elementwise and
norm work in backward — less recompute at slightly more memory. The JAX
package hands the policy to ``jax.checkpoint``; here :func:`checkpoint`
runs a function under non-reentrant ``torch.utils.checkpoint``, with a
selective-checkpoint context for "dots".
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint as _checkpoint,
                                    create_selective_checkpoint_contexts)

#: the matmuls whose outputs "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: Optional[str]):
    """The selective-checkpoint policy of ``name``: None (full remat) or
    the "dots" policy function. Any other name raises ``ValueError``."""
    if name is None:
        return None
    if name == "dots":
        return _save_dots
    raise ValueError(f"unknown remat policy {name!r}")


def checkpoint(fn: Callable, policy: Optional[str] = None) -> Callable:
    """``fn`` rematerialised under the named policy: its activations are
    recomputed in the backward pass (all but the matmul outputs under
    "dots"). The counterpart of ``jax.checkpoint(fn, policy=...)``."""
    pol = resolve_remat_policy(policy)
    kw = {} if pol is None else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts, pol)}

    @functools.wraps(fn)
    def wrapped(*args):
        return _checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped
