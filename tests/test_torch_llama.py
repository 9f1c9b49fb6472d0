"""The port's LLaMA serving model (flexflow_tpu_torch/models/llama.py)
held against the JAX package's on the same weights and inputs, f32 on
the CPU."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu_torch.models import llama as tl

torch.set_num_threads(1)

# f32 logits of a 2-layer tiny model: the frameworks' GEMMs sum in other
# orders, ~1e-6 relative; 1e-4 leaves room without hiding a real error
# (logits are O(1)).
LOGIT_ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(11), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(_np_tree(params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def test_rope_and_rms_match_jax(models):
    cfg_j, _, cfg_t, _ = models
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 2048, size=(3, 5)).astype(np.int32)
    cos_j, sin_j = jl.rope_freqs(cfg_j, jnp.asarray(pos))
    cos_t, sin_t = tl.rope_freqs(cfg_t, torch.from_numpy(pos))
    # angles up to 2048 rad: the two libraries' f32 cos/sin agree to ~1e-4
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-4)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-4)
    x = rng.normal(size=(3, 5, 4, cfg_t.head_dim)).astype(np.float32)
    rot_j = jl.apply_rope(jnp.asarray(x), cos_j, sin_j)
    rot_t = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(cos_j)),
                          torch.from_numpy(np.array(sin_j)))
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=1e-6)
    h = rng.normal(size=(3, 5, cfg_t.hidden_size)).astype(np.float32)
    g = rng.normal(size=(cfg_t.hidden_size,)).astype(np.float32)
    np.testing.assert_allclose(
        tl._rms(torch.from_numpy(h), torch.from_numpy(g), 1e-6).numpy(),
        np.asarray(jl._rms(jnp.asarray(h), jnp.asarray(g), 1e-6)),
        atol=1e-6, rtol=1e-5,
    )


def _steps(S1):
    """Three serving steps over 3 slots: a ragged prefill chunk (padding
    at the scratch line), a decode step, then a tree-verify step with an
    explicit mask and separate cache lines."""
    scratch = S1 - 1
    tok1 = np.asarray([[5, 6, 7, 8], [9, 10, 0, 0], [11, 12, 13, 0]], np.int32)
    pos1 = np.asarray([[0, 1, 2, 3], [0, 1, scratch, scratch],
                       [0, 1, 2, scratch]], np.int32)
    idx1 = np.asarray([3, 1, 2], np.int32)
    tok2 = np.asarray([[20], [21], [22]], np.int32)
    pos2 = np.asarray([[4], [2], [3]], np.int32)
    idx2 = np.zeros((3,), np.int32)
    # tree: root + two siblings at depth 1 (same position, distinct lines)
    tok3 = np.asarray([[30, 31, 32]] * 3, np.int32)
    prefix = np.asarray([5, 3, 4])
    pos3 = np.stack([prefix, prefix + 1, prefix + 1], 1).astype(np.int32)
    cpos3 = np.stack([prefix, prefix + 1, prefix + 2], 1).astype(np.int32)
    mask3 = np.zeros((3, 3, S1), bool)
    for r in range(3):
        mask3[r, :, : prefix[r] + 1] = True      # prefix + root
        mask3[r, 1, prefix[r] + 1] = True
        mask3[r, 2, prefix[r] + 2] = True
    return [
        (tok1, pos1, idx1, None, None),
        (tok2, pos2, idx2, None, None),
        (tok3, pos3, idx2, mask3, cpos3),
    ]


@pytest.mark.parametrize("jax_kernels,port_kernels",
                         [("pallas", "cuda"), ("xla", "torch")])
def test_serve_step_matches_jax(models, jax_kernels, port_kernels):
    cfg_j, params_j, cfg_t, params_t = models
    max_len = 40
    cache_j = jl.init_kv_cache(cfg_j, 3, max_len, jnp.float32)
    cache_t = tl.init_kv_cache(cfg_t, 3, max_len, torch.float32)
    S1 = max_len + 1
    for tok, pos, idx, mask, cpos in _steps(S1):
        all_logits = mask is not None
        lj, cache_j = jl.serve_step(
            params_j, cache_j, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(idx), None if mask is None else jnp.asarray(mask),
            None if cpos is None else jnp.asarray(cpos),
            cfg=cfg_j, all_logits=all_logits, kernels=jax_kernels,
        )
        lt, out_cache = tl.serve_step(
            params_t, cache_t, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(idx), None if mask is None else torch.from_numpy(mask),
            None if cpos is None else torch.from_numpy(cpos),
            cfg=cfg_t, all_logits=all_logits, kernels=port_kernels,
        )
        assert out_cache is cache_t  # updated in place
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL)
    # every written cache line (the scratch line aside) agrees too
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name][:, :, :-1].numpy(),
                                   np.asarray(cache_j[name])[:, :, :-1],
                                   atol=1e-5)


def test_params_from_numpy_round_trip_bf16():
    cfg_j = jl.LLaMAConfig.tiny()  # bf16
    tree = _np_tree(jl.init_params(jax.random.PRNGKey(1), cfg_j))
    params = tl.params_from_numpy(tree, device="cpu")
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert set(params) == set(tree) and set(params["layers"]) == set(tree["layers"])

    def back(t):
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)

    for name in ("embed", "lm_head", "final_norm"):
        np.testing.assert_array_equal(back(params[name]), tree[name])
    for name, a in tree["layers"].items():
        assert params["layers"][name].shape == a.shape
        np.testing.assert_array_equal(back(params["layers"][name]), a)


def test_params_from_numpy_casts():
    tree = _np_tree(jl.init_params(jax.random.PRNGKey(1), jl.LLaMAConfig.tiny()))
    params = tl.params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert params["embed"].dtype == torch.float32
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  tree["embed"].astype(np.float32))


def test_init_params_is_seeded_and_shaped():
    cfg = tl.LLaMAConfig.tiny(dtype=torch.float32)
    a = tl.init_params(torch.Generator().manual_seed(3), cfg)
    b = tl.init_params(torch.Generator().manual_seed(3), cfg)
    tree = jl.init_params(jax.random.PRNGKey(0), jl.LLaMAConfig.tiny())
    assert torch.equal(a["layers"]["w1"], b["layers"]["w1"])
    assert a["layers"]["w2"].shape == tree["layers"]["w2"].shape
    assert a["lm_head"].shape == tree["lm_head"].shape
