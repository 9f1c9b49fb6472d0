"""The port's training flash attention (flexflow_tpu_torch/ops/
flash_attention.py) held against the JAX package's Pallas kernels, run in
interpret mode on the CPU as tests/test_flash_attention.py runs them
(blocks of 16, so S = 24 and 40 leave padded blocks), on the same
numpy-seeded inputs, f32. The port's layout is (B, S, H, dk) with the
LSE (B, H, S); the JAX kernels take (B·H, S, dk) and (B·H, S)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.ops import flash_attention as jf
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.ops import flash_attention as tf

torch.set_num_threads(1)

# forward: the same f32 arithmetic in another order (the JAX kernel's
# online softmax over blocks of 16), ~1e-6
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
# backward: sums over the whole sequence, as tests/test_flash_attention.py
BWD_TOL = dict(rtol=5e-4, atol=5e-5)
BLOCK = 16
# (S, T): aligned, padded query and key blocks, S != T both ways
SHAPES = [(16, 16), (24, 24), (40, 40), (24, 40), (40, 24)]


def _inputs(seed, B, S, T, H, dk):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dk)).astype(np.float32)
    k = rng.normal(size=(B, T, H, dk)).astype(np.float32)
    v = rng.normal(size=(B, T, H, dk)).astype(np.float32)
    do = rng.normal(size=(B, S, H, dk)).astype(np.float32)
    return q, k, v, do


def _heads_first(a):
    """(B, S, H, dk) numpy → the JAX kernels' (B·H, S, dk)."""
    B, S, H, dk = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, dk))


def _port_to_jax_layout(t):
    B, S, H, dk = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * H, S, dk).detach().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", SHAPES)
def test_flash_fwd_ref_matches_jax_kernel(S, T, causal):
    q, k, v, _ = _inputs(0, 2, S, T, 2, 32)
    scale = 1.0 / np.sqrt(32)
    out_j, lse_j = jf._flash_fwd(_heads_first(q), _heads_first(k), _heads_first(v),
                                 causal, scale, BLOCK, BLOCK)
    out_t, lse_t = tf.flash_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal, scale)
    assert out_t.shape == q.shape and lse_t.shape == (2, 2, S)
    np.testing.assert_allclose(_port_to_jax_layout(out_t), np.asarray(out_j), **FWD_TOL)
    np.testing.assert_allclose(lse_t.reshape(4, S).numpy(), np.asarray(lse_j), **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", SHAPES)
def test_flash_bwd_ref_matches_jax_kernel(S, T, causal):
    """On the same forward outputs and the same do: the recomputation from
    the LSE, not autograd of the forward."""
    q, k, v, do = _inputs(1, 2, S, T, 2, 32)
    scale = 1.0 / np.sqrt(32)
    qj, kj, vj = _heads_first(q), _heads_first(k), _heads_first(v)
    out_j, lse_j = jf._flash_fwd(qj, kj, vj, causal, scale, BLOCK, BLOCK)
    got_j = jf._flash_bwd(qj, kj, vj, out_j, lse_j, _heads_first(do), causal, scale,
                          BLOCK, BLOCK)
    # the port's backward on the JAX forward's own out and lse
    B, H = 2, 2
    out_t = torch.from_numpy(np.array(out_j)).reshape(B, H, S, 32).permute(0, 2, 1, 3)
    lse_t = torch.from_numpy(np.array(lse_j)).reshape(B, H, S)
    got_t = tf.flash_bwd_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             out_t, lse_t, torch.from_numpy(do), causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got_t, got_j):
        np.testing.assert_allclose(_port_to_jax_layout(a), np.asarray(b), **BWD_TOL,
                                   err_msg=f"{name} (S={S}, T={T}, causal={causal})")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [16, 40])
def test_flash_attention_grads_match_jax(S, causal):
    """The autograd Function against jax.grad through the custom VJP."""
    q, k, v, do = _inputs(2, 1, S, S, 2, 16)

    def loss_j(q, k, v):
        out = jf.flash_attention(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tf.flash_attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jf.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, block_q=BLOCK, block_k=BLOCK)),
        **FWD_TOL)
    (out * torch.from_numpy(do)).sum().backward()
    for name, t, w in zip("qkv", (qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **BWD_TOL,
                                   err_msg=f"d{name}")


def test_flash_gqa_via_model_attn_fn_matches_jax_attention():
    """make_flash_attention repeats the compact KV heads before the kernel:
    equal to the plain GQA attention under causal_mask, in both packages,
    and its gradients reach the compact K/V."""
    cfg_j = jl.LLaMAConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=1, num_attention_heads=4,
                           num_key_value_heads=2, max_position_embeddings=32,
                           dtype=jnp.float32)
    cfg_t = tl.LLaMAConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=1, num_attention_heads=4,
                           num_key_value_heads=2, max_position_embeddings=32,
                           dtype=torch.float32)
    rng = np.random.default_rng(3)
    B, S = 2, 24
    q = rng.normal(size=(B, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(B, S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(B, S, 2, 16)).astype(np.float32)
    want = jl.attention(cfg_j, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jl.causal_mask(S))
    kt = torch.from_numpy(k).requires_grad_(True)
    got = tl.make_flash_attention()(cfg_t, torch.from_numpy(q), kt, torch.from_numpy(v),
                                    None)
    plain = tl.attention(cfg_t, torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), tl.causal_mask(S))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **FWD_TOL)
    got.sum().backward()
    assert kt.grad.shape == k.shape and bool(torch.isfinite(kt.grad).all())


def test_cpu_path_launches_no_kernel():
    q, k, v, do = _inputs(4, 1, 24, 24, 2, 16)
    tf.reset_launch_counts()
    qt = torch.from_numpy(q).requires_grad_(True)
    out = tf.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v))
    out.backward(torch.from_numpy(do))
    assert all(n == 0 for n in tf.LAUNCHES.values()), tf.LAUNCHES
    assert set(tf.LAUNCHES) == {"flash_attention_fwd", "flash_attention_bwd_kv",
                                "flash_attention_bwd_q"}


def test_wrappers_reject_mismatched_shapes():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="repeat GQA heads"):
        tf.flash_fwd(q, torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16), True, 0.25)
    with pytest.raises(ValueError, match="lse"):
        tf.flash_bwd(q, q, q, q, torch.zeros(1, 8, 2), q, True, 0.25)
