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
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch


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
        wd = self.weight_decay
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
            g = g.to(torch.float32)
            if wd:
                g = g + wd * p.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = alpha_t * m
            upd.div_(torch.sqrt(v).add_(self.epsilon))
            p.copy_(p.to(torch.float32) - upd)
        return params, opt_state
