"""The port's attention kernels (flexflow_tpu_torch/serve/kernels.py).

On the CPU each wrapper runs its plain PyTorch version, which is held
here against the JAX package's Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them). The CUDA kernels themselves are held
against the plain versions on the GPU by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import kernels as jk
from flexflow_tpu_torch.serve import kernels as tk

torch.set_num_threads(1)

R, S1, H, KV, dk = 4, 96, 8, 4, 16
# f32 on the CPU: the online softmax of the Pallas kernel and the plain
# version's one-pass softmax differ only in summation order
ATOL = 2e-5


def _qkv(rng, C=None):
    qshape = (R, H, dk) if C is None else (R, C, H, dk)
    q = rng.normal(size=qshape).astype(np.float32)
    k = rng.normal(size=(R, S1, KV, dk)).astype(np.float32)
    v = rng.normal(size=(R, S1, KV, dk)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_decode_ref_matches_jax_decode_attention():
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    seq_lens = np.asarray([0, 17, 64, 96], np.int32)  # slot 0 attends nothing
    want = jk.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(seq_lens), block_s=32)
    got = tk.decode_attention_ref(*_t(q, k, v, seq_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[0] == 0).all()


def _tree_mask(rng, C):
    mask = np.zeros((R, C, S1), bool)
    for r in range(R):
        pref = rng.integers(1, 40)
        mask[r, :, :pref] = True
        for c in range(C):
            mask[r, c, pref + rng.integers(0, C)] = True
    return mask


def _chunk_mask(C):
    """Causal chunked-prefill mask: row r's chunk starts at offset 10 r,
    its last column is padding at the scratch position."""
    pos = np.full((R, C), S1 - 1, np.int32)
    for r in range(R):
        pos[r, : C - 1] = np.arange(10 * r, 10 * r + C - 1)
    return np.array(jk.causal_serve_mask(jnp.asarray(pos), S1))


@pytest.mark.parametrize("kind", ["tree", "chunk"])
def test_verify_ref_matches_jax_verify_attention(kind):
    rng = np.random.default_rng(2)
    C = 8
    q, k, v = _qkv(rng, C)
    mask = _tree_mask(rng, C) if kind == "tree" else _chunk_mask(C)
    mask[1, 3] = False  # one fully masked row
    want = jk.verify_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), block_s=32)
    got = tk.verify_attention_ref(*_t(q, k, v, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[1, 3] == 0).all()


def test_causal_serve_mask_matches_jax():
    pos = np.asarray([[0, 5, 95], [3, 95, 95]], np.int32)
    want = np.asarray(jk.causal_serve_mask(jnp.asarray(pos), S1))
    got = tk.causal_serve_mask(torch.from_numpy(pos), S1).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_on_cpu_run_the_plain_versions():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng)
    seq_lens = np.asarray([1, 0, 50, 96], np.int32)
    before = dict(tk.LAUNCHES)
    got = tk.decode_attention(*_t(q, k, v, seq_lens))
    want = tk.decode_attention_ref(*_t(q, k, v, seq_lens))
    assert torch.equal(got, want)
    C = 5
    q, k, v = _qkv(rng, C)
    mask = _tree_mask(rng, C)
    got = tk.verify_attention(*_t(q, k, v, mask))
    want = tk.verify_attention_ref(*_t(q, k, v, mask))
    assert torch.equal(got, want)
    assert tk.LAUNCHES == before  # no kernel launched on the CPU


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(4)
    q, k, v = _t(*_qkv(rng))
    with pytest.raises(ValueError):
        tk.decode_attention(q, k, v[:, :10], torch.zeros(R, dtype=torch.int32))
    with pytest.raises(ValueError):
        tk.decode_attention(q, k, v, torch.zeros(R + 1, dtype=torch.int32))
    q4 = q[:, None]
    with pytest.raises(ValueError):
        tk.verify_attention(q4, k, v, torch.ones(R, 1, S1, dtype=torch.uint8))


def test_plain_versions_scale_argument():
    """An explicit scale equals pre-scaling q by scale * sqrt(dk)."""
    rng = np.random.default_rng(5)
    q, k, v = _t(*_qkv(rng))
    sl = torch.tensor([3, 96, 40, 1], dtype=torch.int32)
    s = 0.3
    a = tk.decode_attention_ref(q, k, v, sl, scale=s)
    b = tk.decode_attention_ref(q * (s * math.sqrt(dk)), k, v, sl)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

