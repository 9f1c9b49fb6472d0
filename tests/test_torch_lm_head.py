"""The port's LM head (flexflow_tpu_torch/models/llama.py ``lm_head``, a
``torch.autograd.Function``) on the CPU: the logits and gradients of the
f32 product it replaced, its hi + lo split of the logits' gradient held
to the f32 backward, and a 2-layer f32 forward held to the JAX
package's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu_torch.models import llama as tl

torch.set_num_threads(1)

# f32 logits of a 2-layer tiny model: the frameworks' GEMMs sum in other
# orders, ~1e-6 relative (tests/test_torch_train.py's LOGIT_ATOL)
LOGIT_ATOL = 1e-4
# the hi + lo split keeps g to ~2^-16 relative; a product of it is held to
# the f32 product within 2^-14 relative L2
SPLIT_REL_L2 = 2.0 ** -14


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _inputs(seed, dtype, N=12, D=32, V=40):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, N // 2, D)).astype(np.float32)).to(dtype)
    head = torch.from_numpy((rng.normal(size=(D, V)) / np.sqrt(D)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, N // 2, V)).astype(np.float32))
    return x, head.to(dtype), g


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied-embed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_function_gives_the_f32_product_and_its_gradients(dtype, tied):
    """On the CPU the Function's logits and both gradients equal, bit for
    bit, those of the product it replaced, ``matmul(x.f32, head.f32)``
    under autograd, for an untied head and for a tied one read as
    ``embed.T``."""
    x, head, g = _inputs(0, dtype)
    outs = []
    for fn in (tl.lm_head, lambda a, b: torch.matmul(a.to(torch.float32),
                                                     b.to(torch.float32))):
        xa = x.clone().requires_grad_(True)
        w = (head.T.contiguous() if tied else head.clone()).requires_grad_(True)
        logits = fn(xa, w.T if tied else w)
        logits.backward(g)
        outs.append((logits.detach(), xa.grad, w.grad))
    (lg, dx, dw), (lw, dxw, dww) = outs
    assert lg.dtype == torch.float32 and dx.dtype == dtype and dw.dtype == dtype
    assert torch.equal(lg, lw) and torch.equal(dx, dxw) and torch.equal(dw, dww)


def test_head_function_leaves_an_unneeded_gradient():
    x, head, g = _inputs(1, torch.float32)
    x.requires_grad_(True)
    tl.lm_head(x, head).backward(g)
    assert x.grad is not None and head.grad is None


def test_split_is_exact_to_two_to_the_minus_sixteen():
    """hi + lo reproduces g to ~2^-16 relative, elementwise; hi alone is
    bf16's rounding (~2^-9)."""
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(64, 80)).astype(np.float32))
    hi, lo = tl.split_hi_lo(g)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.to(torch.float32) + lo.to(torch.float32) - g).abs()
    assert float((err / g.abs()).max()) <= 2.0 ** -16
    assert float(((hi.to(torch.float32) - g).abs() / g.abs()).max()) > 2.0 ** -12


@pytest.mark.parametrize("seed", [3, 4])
def test_split_backward_in_f32_matches_the_f32_backward(seed):
    """head_backward_split's products, each taken in f32 on the CPU (the
    bf16 x and head exact in f32), give dx and dW within 2^-14 relative L2
    of the f32 backward on the undivided g."""
    x, head, g = _inputs(seed, torch.bfloat16, N=48, D=64, V=96)
    x2, g2 = x.reshape(-1, 64), g.reshape(-1, 96)

    def mm_f32(a, b):
        return torch.mm(a.to(torch.float32), b.to(torch.float32))

    dx, dw = tl.head_backward_split(x2, head, g2, mm=mm_f32)
    want_dx = torch.mm(g2, head.to(torch.float32).T)
    want_dw = torch.mm(x2.to(torch.float32).T, g2)
    assert dx.dtype == dw.dtype == torch.float32
    assert _rel_l2(dx, want_dx) <= SPLIT_REL_L2
    assert _rel_l2(dw, want_dw) <= SPLIT_REL_L2
    # each gradient only where asked for
    assert tl.head_backward_split(x2, head, g2, mm=mm_f32, need=(False, True))[0] is None


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied-embed"])
def test_two_layer_f32_forward_matches_jax(tied):
    """A 2-layer f32 forward, whose last product is the Function, stays
    within LOGIT_ATOL of JAX's ``forward`` on the same weights and
    tokens."""
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32, tie_word_embeddings=tied)
    cfg_t = dataclasses.replace(tl.LLaMAConfig.tiny(dtype=torch.float32),
                                tie_word_embeddings=tied)
    tree = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(6), cfg_j))
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 17)).astype(np.int32)
    with torch.no_grad():
        got = tl.forward(tl.params_from_numpy(tree, device="cpu"), torch.from_numpy(toks),
                         cfg_t)
    want = jl.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), cfg_j)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
