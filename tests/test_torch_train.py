"""The port's LLaMA training path (flexflow_tpu_torch/models/llama.py
forward / next_token_loss / make_train_step, optimizers.py, core/remat.py)
held against the JAX package's on the same weights (JAX ``init_params``
carried across with ``params_from_numpy``) and the same numpy-seeded
tokens, f32 on the CPU. The JAX flash path runs its Pallas kernels in
interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optimizers as jopt
from flexflow_tpu.core.mesh import MachineSpec
from flexflow_tpu.core.mesh import set_mesh as _set_mesh
from flexflow_tpu.models import llama as jl
from flexflow_tpu_torch import optimizers as topt
from flexflow_tpu_torch.core import remat as tremat
from flexflow_tpu_torch.models import llama as tl

torch.set_num_threads(1)

# f32 logits and losses of a 2-layer tiny model: the frameworks' GEMMs
# sum in other orders, ~1e-6 relative (as tests/test_torch_llama.py)
LOGIT_ATOL = 1e-4
# losses and params over three SGD steps
TRAJ_RTOL = 1e-5
# one optimizer update on identical grads: f32 elementwise math, a few ulp
OPT_RTOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(5), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    return cfg_j, _np_tree(params_j), cfg_t


def _port_params(tree):
    return tl.params_from_numpy(tree, device="cpu")


def test_forward_and_loss_match_jax(models):
    cfg_j, tree, cfg_t = models
    toks = _tokens(0, 2, 21, cfg_t.vocab_size)
    params = _port_params(tree)
    with torch.no_grad():
        got = tl.forward(params, torch.from_numpy(toks), cfg_t)
        loss = tl.next_token_loss(params, torch.from_numpy(toks), cfg_t)
    assert got.dtype == torch.float32 and got.shape == (2, 21, cfg_t.vocab_size)
    want = jl.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), cfg_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    want_loss = jl.next_token_loss(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), cfg_j)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TRAJ_RTOL)


def _jax_trajectory(cfg_j, tree, toks, attention, remat, policy, steps):
    mesh = MachineSpec().make_mesh(jax.devices()[:1])
    with _set_mesh(mesh):
        _, step, ds = jl.make_train_step(
            cfg_j, mesh, jopt.SGDOptimizer(lr=0.5), remat=remat is not False,
            remat_policy=policy, shard_activations=False,
            attention="flash" if attention == "flash" else "xla")
        params = jax.tree.map(jnp.array, tree)  # copies: the step donates them
        opt = jopt.SGDOptimizer(lr=0.5).init(params)
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, jax.device_put(toks, ds))
            losses.append(float(loss))
    return losses, _np_tree(params)


# (remat, remat_policy): off, full per-block remat, matmul outputs saved
REMATS = [(False, None), (True, None), (True, "dots")]


@pytest.mark.parametrize("remat,policy", REMATS, ids=["off", "full", "dots"])
@pytest.mark.parametrize("attention", ["torch", "flash"])
def test_sgd_trajectory_matches_jax(models, attention, remat, policy):
    cfg_j, tree, cfg_t = models
    toks = _tokens(1, 2, 25, cfg_t.vocab_size)
    want_losses, want_params = _jax_trajectory(cfg_j, tree, toks, attention, remat,
                                               policy, 3)
    _, step = tl.make_train_step(cfg_t, topt.SGDOptimizer(lr=0.5), device="cpu",
                                 remat=remat, remat_policy=policy, attention=attention)
    params = _port_params(tree)
    opt = topt.SGDOptimizer(lr=0.5).init(params)
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=TRAJ_RTOL)
    assert losses[-1] < losses[0]
    got, want = _leaves_by_key(params), jax.tree.leaves(want_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL, atol=1e-6)


def _leaves_by_key(tree):
    """A port tree's tensors as numpy, in JAX's sorted-key leaf order."""
    return jax.tree.leaves(jax.tree.map(lambda t: t.detach().numpy(), tree))


def _grads(seed, tree):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("opt_j,opt_t", [
    (jopt.SGDOptimizer(lr=0.1), topt.SGDOptimizer(lr=0.1)),
    (jopt.SGDOptimizer(lr=0.1, momentum=0.9, weight_decay=0.01),
     topt.SGDOptimizer(lr=0.1, momentum=0.9, weight_decay=0.01)),
    (jopt.SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01),
     topt.SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01)),
    (jopt.AdamOptimizer(lr=1e-2), topt.AdamOptimizer(lr=1e-2)),
    (jopt.AdamOptimizer(lr=1e-2, weight_decay=0.01),
     topt.AdamOptimizer(lr=1e-2, weight_decay=0.01)),
], ids=["sgd", "sgd-momentum-wd", "sgd-nesterov-wd", "adam", "adam-wd"])
def test_optimizer_update_matches_jax(models, opt_j, opt_t):
    """Four updates on identical grads: params and state as JAX's."""
    _, tree, _ = models
    params_j = jax.tree.map(jnp.asarray, tree)
    state_j = opt_j.init(params_j)
    params_t = _port_params(tree)
    state_t = opt_t.init(params_t)
    for i in range(4):
        g = _grads(10 + i, tree)
        params_j, state_j = opt_j.update(jax.tree.map(jnp.asarray, g), state_j, params_j)
        ret = opt_t.update(_port_params(g), state_t, params_t)
        assert ret[0] is params_t and ret[1] is state_t  # updated in place
    for got, want in zip(_leaves_by_key(params_t), jax.tree.leaves(params_j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=OPT_RTOL, atol=1e-7)
    assert set(state_t) == set(state_j)
    for key in ("m", "v"):
        if key in state_j:
            for got, want in zip(_leaves_by_key(state_t[key]), jax.tree.leaves(state_j[key])):
                np.testing.assert_allclose(got, np.asarray(want), rtol=OPT_RTOL, atol=1e-9)
    if "step" in state_j:
        assert int(state_t["step"]) == int(state_j["step"]) == 4
    assert float(state_t["lr"]) == float(state_j["lr"])


def test_adam_state_is_f32_for_bf16_params():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16)}
    opt = topt.AdamOptimizer(lr=0.1)
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.float32 and state["step"].dtype == torch.int32
    opt.update({"w": torch.full((3, 2), 0.5, dtype=torch.bfloat16)}, state, params)
    assert params["w"].dtype == torch.bfloat16
    # first Adam step moves each weight by lr * sign(g), up to eps
    np.testing.assert_allclose(params["w"].float().numpy(), 0.9, rtol=1e-2)


def test_adam_loss_falls_over_five_steps():
    cfg = tl.LLaMAConfig.tiny(dtype=torch.float32)
    init, step = tl.make_train_step(cfg, topt.AdamOptimizer(lr=1e-2), device="cpu",
                                    attention="flash")
    params, opt = init(torch.Generator().manual_seed(0))
    assert all(p.requires_grad and p.is_leaf for p in topt.tree_leaves(params))
    toks = torch.from_numpy(_tokens(2, 4, 17, cfg.vocab_size))
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(opt["step"]) == 5


def test_make_train_step_refuses_parallel_training():
    cfg = tl.LLaMAConfig.tiny(dtype=torch.float32)
    opt = topt.SGDOptimizer()
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tl.make_train_step(cfg, opt, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tl.make_train_step(cfg, opt, device="cpu", num_microbatches=2)
    with pytest.raises(ValueError, match="attention"):
        tl.make_train_step(cfg, opt, device="cpu", attention="xla")
    with pytest.raises(ValueError, match="remat policy"):
        tl.make_train_step(cfg, opt, device="cpu", remat_policy="everything")


def test_resolve_remat_policy():
    assert tremat.resolve_remat_policy(None) is None
    assert callable(tremat.resolve_remat_policy("dots"))
    with pytest.raises(ValueError, match="unknown remat policy"):
        tremat.resolve_remat_policy("offload")


def test_num_params_and_flops_match_jax():
    for kw in ({}, {"num_hidden_layers": 8}, {"tie_word_embeddings": True}):
        cj, ct = jl.LLaMAConfig.llama_7b(**kw), tl.LLaMAConfig.llama_7b(**kw)
        assert tl.num_params(ct) == jl.num_params(cj)
        assert tl.flops_per_token(ct, 2048) == jl.flops_per_token(cj, 2048)
