"""The port's Adam update as a kernel with a plain version
(flexflow_tpu_torch/optimizers.py ``adam_update`` and
``adam_update_ref``) on the CPU: the plain version is bitwise the update
the optimizer made before it moved into a named function, and
``AdamOptimizer.update``'s, and stays within OPT_RTOL of the JAX
package's update on identical grads. The kernel itself runs only on a
GPU (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optimizers as jopt
from flexflow_tpu_torch import optimizers as topt

torch.set_num_threads(1)

# one update on identical grads: f32 elementwise math, a few ulp
# (tests/test_torch_train.py's OPT_RTOL)
OPT_RTOL = 1e-6
B1, B2, EPS = 0.9, 0.999, 1e-8


def _loop_body(p, g, m, v, alpha_t, wd):
    """The per-parameter body of ``AdamOptimizer.update`` as it read before
    it became :func:`adam_update_ref`, kept here as the yardstick."""
    g = g.to(torch.float32)
    if wd:
        g = g + wd * p.to(torch.float32)
    m.mul_(B1).add_((1 - B1) * g)
    v.mul_(B2).add_((1 - B2) * g * g)
    upd = alpha_t * m
    upd.div_(torch.sqrt(v).add_(EPS))
    p.copy_(p.to(torch.float32) - upd)


def _leaf(rng, dtype, n=1003):
    return torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dtype)


def _alpha(lr, t):
    t = torch.tensor(float(t))
    return torch.tensor(lr) * torch.sqrt(1.0 - torch.pow(B2, t)) / (1.0 - torch.pow(B1, t))


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no-wd", "wd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_adam_is_the_loop_body_bitwise(dtype, wd):
    """Five steps of adam_update_ref and of adam_update (the CPU wrapper)
    equal the former loop body bit for bit in p, m and v; no launch is
    counted on the CPU."""
    rng = np.random.default_rng(0)
    p0 = _leaf(rng, dtype)
    states = [[p0.clone(), torch.zeros(p0.shape), torch.zeros(p0.shape)] for _ in range(3)]
    launches = topt.LAUNCHES["adam_update"]
    for t in range(1, 6):
        g = _leaf(rng, dtype)
        a = _alpha(1e-2, t)
        _loop_body(*states[0][:1], g, *states[0][1:], a, wd)
        topt.adam_update_ref(states[1][0], g, states[1][1], states[1][2], a, B1, B2, EPS, wd)
        topt.adam_update(states[2][0], g, states[2][1], states[2][2], a, B1, B2, EPS, wd)
    for got in states[1:]:
        for x, y in zip(got, states[0]):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert topt.LAUNCHES["adam_update"] == launches


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no-wd", "wd"])
def test_optimizer_update_is_the_plain_function_on_every_leaf(wd):
    """AdamOptimizer.update on a tree of bf16 and f32 leaves equals
    adam_update_ref run leaf by leaf with the step's alpha_t, bitwise."""
    rng = np.random.default_rng(1)
    params = {"a": _leaf(rng, torch.bfloat16), "b": {"c": _leaf(rng, torch.float32, 17)}}
    mine = topt.tree_unflatten(params, [t.clone() for t in topt.tree_leaves(params)])
    opt = topt.AdamOptimizer(lr=3e-3, weight_decay=wd)
    state = opt.init(params)
    ms = [torch.zeros(t.shape) for t in topt.tree_leaves(mine)]
    vs = [torch.zeros(t.shape) for t in topt.tree_leaves(mine)]
    for t in range(1, 4):
        grads = topt.tree_unflatten(params, [_leaf(rng, x.dtype, x.numel())
                                             for x in topt.tree_leaves(params)])
        opt.update(grads, state, params)
        a = torch.tensor(3e-3) * torch.sqrt(1.0 - torch.pow(B2, torch.tensor(float(t)))) / (
            1.0 - torch.pow(B1, torch.tensor(float(t))))
        for p, g, m, v in zip(topt.tree_leaves(mine), topt.tree_leaves(grads), ms, vs):
            topt.adam_update_ref(p, g, m, v, a, B1, B2, EPS, wd)
    for x, y in zip(topt.tree_leaves(params), topt.tree_leaves(mine)):
        assert torch.equal(x, y)
    for key, mine_state in (("m", ms), ("v", vs)):
        for x, y in zip(topt.tree_leaves(state[key]), mine_state):
            assert torch.equal(x, y)


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no-wd", "wd"])
def test_plain_adam_matches_jax_update(wd):
    """Four steps of adam_update_ref on f32 leaves against the JAX
    AdamOptimizer's update on the same grads, at OPT_RTOL."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(7, 9)).astype(np.float32)
    jo = jopt.AdamOptimizer(lr=1e-2, weight_decay=wd)
    jp = {"w": jnp.asarray(p0)}
    js = jo.init(jp)
    p, m, v = torch.from_numpy(p0.copy()), torch.zeros(7, 9), torch.zeros(7, 9)
    for t in range(1, 5):
        g = rng.normal(size=(7, 9)).astype(np.float32)
        jp, js = jo.update({"w": jnp.asarray(g)}, js, jp)
        topt.adam_update_ref(p, torch.from_numpy(g), m, v, _alpha(1e-2, t), B1, B2, EPS, wd)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp["w"]), rtol=OPT_RTOL, atol=1e-7)
    np.testing.assert_allclose(m.numpy(), np.asarray(js["m"]["w"]), rtol=OPT_RTOL, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), np.asarray(js["v"]["w"]), rtol=OPT_RTOL, atol=1e-9)


def test_adam_update_checks_shapes():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="one shape"):
        topt.adam_update(p, torch.zeros(5), torch.zeros(4), torch.zeros(4),
                         torch.tensor(0.1), B1, B2, EPS)
