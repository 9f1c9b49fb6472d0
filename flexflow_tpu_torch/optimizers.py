"""Optimizers: SGD (momentum/nesterov) and Adam — the port of
``flexflow_tpu/optimizers.py``.

Same fields, the same ``init(params)`` / ``update(grads, opt_state,
params)`` API over nested dicts of tensors, the same state dict and the
same arithmetic (f32 math, a cast back to each parameter's dtype; Adam's
``alpha_t`` bias correction and ``m / (sqrt(v) + eps)``). One
difference: ``update`` writes the parameters and the state **in place**
under ``torch.no_grad()`` — the JAX step donates both and returns new
ones — and returns the same ``(params, opt_state)`` objects, so a call
reads the same in both packages. It goes one parameter at a time, which
bounds the f32 temporaries to the largest parameter.

Adam's per-parameter update is a kernel (:func:`adam_update`): on CUDA
tensors one launch of ``csrc/adam_update.cu`` a parameter, bitwise the
plain version :func:`adam_update_ref` (the same f32 operations in the
same order), counted in ``LAUNCHES["adam_update"]``; on the CPU the plain
version itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

#: launches of the Adam kernel since the last :func:`reset_launch_counts`
#: (a plain-version call on the CPU does not count)
LAUNCHES: Dict[str, int] = {"adam_update": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for key in tree for t in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in node}
        return next(it)

    return build(like)


def _zeros(params, dtype=None):
    return tree_unflatten(params, [torch.zeros_like(p, dtype=dtype or p.dtype)
                                   for p in tree_leaves(params)])


def _device_scalar(x: float, params) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=tree_leaves(params)[0].device)


class Optimizer:
    """The learning rate lives in ``opt_state["lr"]`` (a device scalar), so
    a scheduler changes it without touching the optimizer."""

    def init(self, params) -> Any:
        raise NotImplementedError

    def update(self, grads, opt_state, params) -> Tuple[Any, Any]:
        """Updates ``params`` and ``opt_state`` in place; returns them."""
        raise NotImplementedError


@dataclasses.dataclass
class SGDOptimizer(Optimizer):
    """lr, momentum, nesterov, weight decay."""

    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init(self, params):
        state = {"lr": _device_scalar(self.lr, params)}
        if self.momentum != 0.0:
            state["v"] = _zeros(params)
        return state

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        wd = self.weight_decay
        lr = opt_state["lr"]
        vs = (tree_leaves(opt_state["v"]) if self.momentum != 0.0
              else [None] * len(tree_leaves(params)))
        for p, g, v in zip(tree_leaves(params), tree_leaves(grads), vs):
            if wd:
                g = g + wd * p
            if v is None:
                step = g
            else:
                v.mul_(self.momentum).add_(g)
                step = g + self.momentum * v if self.nesterov else v
            p.copy_(p.to(torch.float32) - lr * step.to(torch.float32))
        return params, opt_state


@dataclasses.dataclass
class AdamOptimizer(Optimizer):
    """Bias-corrected Adam in the alpha_t running-product form."""

    lr: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        device = tree_leaves(params)[0].device
        return {
            "lr": _device_scalar(self.lr, params),
            "m": _zeros(params, torch.float32),
            "v": _zeros(params, torch.float32),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        opt_state["step"].add_(1)
        b1, b2 = self.beta1, self.beta2
        t = opt_state["step"].to(torch.float32)
        alpha_t = (opt_state["lr"] * torch.sqrt(1.0 - torch.pow(b2, t))
                   / (1.0 - torch.pow(b1, t)))
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
            adam_update(p, g, m, v, alpha_t, b1, b2, self.epsilon, self.weight_decay)
        return params, opt_state


def adam_update_ref(p, g, m, v, alpha_t, beta1: float, beta2: float, eps: float,
                    weight_decay: float = 0.0) -> None:
    """Plain version of one parameter's Adam step, in place: p (its
    dtype), g, and the f32 moments m and v; ``alpha_t`` the step's
    bias-corrected rate, an f32 device scalar. f32 math, the JAX
    update's order and eps placement, a cast back to p's dtype."""
    g = g.to(torch.float32)
    if weight_decay:
        g = g + weight_decay * p.to(torch.float32)
    m.mul_(beta1).add_((1 - beta1) * g)
    v.mul_(beta2).add_((1 - beta2) * g * g)
    upd = alpha_t * m
    upd.div_(torch.sqrt(v).add_(eps))
    p.copy_(p.to(torch.float32) - upd)


def adam_update(p, g, m, v, alpha_t, beta1: float, beta2: float, eps: float,
                weight_decay: float = 0.0) -> None:
    """One parameter's Adam step, in place (arguments as
    :func:`adam_update_ref`): the plain version for tensors on the CPU,
    one launch of the Adam kernel for tensors on a GPU, which reads
    ``alpha_t`` from device memory (no host sync)."""
    if p.shape != g.shape or p.shape != m.shape or p.shape != v.shape:
        raise ValueError(f"p, g, m and v must share one shape; got {tuple(p.shape)}, "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, {tuple(v.shape)}")
    if p.device.type == "cpu":
        adam_update_ref(p, g, m, v, alpha_t, beta1, beta2, eps, weight_decay)
        return
    if p.dtype not in (torch.float32, torch.bfloat16) or g.dtype != p.dtype:
        raise ValueError(f"the Adam kernel takes float32 or bfloat16 p and g of one "
                         f"dtype; got {p.dtype}, {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError("the Adam kernel takes float32 moments")
    if alpha_t.numel() != 1 or alpha_t.dtype != torch.float32:
        raise ValueError("alpha_t must be one float32 value")
    g = g.contiguous()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v), ("alpha_t", alpha_t)):
        if t.device != p.device:
            raise ValueError(f"{name} must lie on {p.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "alpha_t" and t.data_ptr() % 16:  # 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    from .serve import _cuda

    n = p.numel()
    _cuda.launch("adam_update", [p, g, m, v, alpha_t],
                 [n >> 30, n & ((1 << 30) - 1), 1 if p.dtype == torch.bfloat16 else 0],
                 [beta1, 1 - beta1, beta2, 1 - beta2, eps, weight_decay])
    LAUNCHES["adam_update"] += 1
