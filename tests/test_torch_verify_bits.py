"""The packed mask of verify attention (serve/kernels.pack_mask_bits and
verify_attention_bits) on the CPU: the packing against numpy's, the bits
entry bitwise the plain version, and the dense serving step packing its
mask once for every layer (kernels="cuda") or never (kernels="torch",
whose logits stay the JAX package's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import kernels as tk

torch.set_num_threads(1)

# f32 logits of two implementations of the same step: summation order only
LOGIT_ATOL = 1e-4


@pytest.mark.parametrize("S1", [1, 63, 64, 65, 2113])
def test_pack_mask_bits_round_trips_against_numpy(S1):
    """Word w of a row holds lines 64 w .. 64 w + 63, bit j line 64 w + j:
    its bytes are numpy's little-endian packbits of the row, zero-padded
    to whole words, and unpacking gives the mask back."""
    rng = np.random.default_rng(S1)
    mask = rng.random((3, 5, S1)) < 0.4
    mask[0, 0] = True
    mask[1, 2] = False
    bits = tk.pack_mask_bits(torch.from_numpy(mask))
    W = -(-S1 // 64)
    assert bits.shape == (3, 5, W) and bits.dtype == torch.int64
    want = np.packbits(mask, axis=-1, bitorder="little")
    want = np.pad(want, ((0, 0), (0, 0), (0, 8 * W - want.shape[-1])))
    assert (bits.numpy().view(np.uint8).reshape(3, 5, 8 * W) == want).all()
    assert torch.equal(tk.unpack_mask_bits(bits, S1), torch.from_numpy(mask))


@pytest.mark.parametrize("S1", [65, 300])
@pytest.mark.parametrize("C,KV", [(1, 2), (5, 2), (12, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_attention_bits_is_the_plain_version_on_cpu(dtype, C, KV, S1):
    rng = np.random.default_rng(C * S1)
    R, H, dk = 3, 4, 16
    q = torch.from_numpy(rng.normal(size=(R, C, H, dk)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.normal(size=(R, S1, KV, dk)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.normal(size=(R, S1, KV, dk)).astype(np.float32)).to(dtype)
    mask = torch.from_numpy(rng.random((R, C, S1)) < 0.3)
    mask[2, 0] = False  # a row with nothing to attend gives 0
    bits = tk.pack_mask_bits(mask)
    before = {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES}
    out = tk.verify_attention_bits(q, k, v, bits, S1)
    ref = tk.verify_attention_ref(q, k, v, mask)
    assert torch.equal(out, ref) and torch.equal(tk.verify_attention(q, k, v, mask), ref)
    assert (out[2, 0] == 0).all()
    assert {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES} == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="bits"):
        tk.verify_attention_bits(q, k, v, bits[..., :-1], S1)
    with pytest.raises(ValueError, match="S1"):
        tk.verify_attention_bits(q, k, v, bits, S1 + 1)


def _steps(S1):
    """A prefill chunk (slot 1 partly padding), a decode step and a tree
    step with an explicit mask (tests/test_torch_llama.py's steps)."""
    scratch = S1 - 1
    tok1 = np.asarray([[5, 6, 7, 8], [9, 10, 0, 0], [11, 12, 13, 0]], np.int32)
    pos1 = np.asarray([[0, 1, 2, 3], [0, 1, scratch, scratch], [0, 1, 2, scratch]], np.int32)
    tok2 = np.asarray([[20], [21], [22]], np.int32)
    pos2 = np.asarray([[4], [2], [3]], np.int32)
    tok3 = np.asarray([[30, 31, 32]] * 3, np.int32)
    prefix = np.asarray([5, 3, 4])
    pos3 = np.stack([prefix, prefix + 1, prefix + 1], 1).astype(np.int32)
    cpos3 = np.stack([prefix, prefix + 1, prefix + 2], 1).astype(np.int32)
    mask3 = np.zeros((3, 3, S1), bool)
    for r in range(3):
        mask3[r, :, : prefix[r] + 1] = True
        mask3[r, 1, prefix[r] + 1] = True
        mask3[r, 2, prefix[r] + 2] = True
    return [(tok1, pos1, np.asarray([3, 1, 2], np.int32), None, None),
            (tok2, pos2, np.zeros(3, np.int32), None, None),
            (tok3, pos3, np.zeros(3, np.int32), mask3, cpos3)]


@pytest.fixture(scope="module")
def models():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(2), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _run(models, kernels, monkeypatch=None, drop_bits=False):
    _, _, cfg_t, params_t = models
    max_len = 40
    cache = tl.init_kv_cache(cfg_t, 3, max_len, torch.float32)
    if drop_bits:  # every layer takes the bool mask entry instead
        block = tl.serve_block
        monkeypatch.setattr(tl, "serve_block", lambda *a: block(*a[:10]))
    out = []
    for tok, pos, idx, mask, cpos in _steps(max_len + 1):
        lt, _ = tl.serve_step(
            params_t, cache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(idx), None if mask is None else torch.from_numpy(mask),
            None if cpos is None else torch.from_numpy(cpos), cfg=cfg_t,
            all_logits=mask is not None, kernels=kernels)
        out.append(lt)
    return out, cache


def test_serve_step_packs_the_mask_once_a_step(models, monkeypatch):
    """kernels="cuda": one pack a step of C > 1, none at decode, every
    layer's verify call on the packed words, the logits and cache bitwise
    those of the bool-mask entry. kernels="torch": no pack and no verify
    call, the logits the JAX package's serve_step (its "xla" path)."""
    cfg_j, params_j, cfg_t, _ = models
    calls = {"pack": 0, "bits": 0}
    pack, verify_bits = tk.pack_mask_bits, tk.verify_attention_bits

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tk, "pack_mask_bits", count("pack", pack))
    monkeypatch.setattr(tk, "verify_attention_bits", count("bits", verify_bits))
    got, cache = _run(models, "cuda")
    assert calls == {"pack": 2, "bits": 2 * cfg_t.num_hidden_layers}
    torch_logits, torch_cache = _run(models, "torch")
    assert calls == {"pack": 2, "bits": 2 * cfg_t.num_hidden_layers}
    want, want_cache = _run(models, "cuda", monkeypatch, drop_bits=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for name in ("k", "v"):
        assert torch.equal(cache[name], want_cache[name])
    cache_j = jl.init_kv_cache(cfg_j, 3, 40, jnp.float32)
    for lt, (tok, pos, idx, mask, cpos) in zip(torch_logits, _steps(41)):
        lj, cache_j = jl.serve_step(
            params_j, cache_j, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(idx),
            None if mask is None else jnp.asarray(mask),
            None if cpos is None else jnp.asarray(cpos), cfg=cfg_j,
            all_logits=mask is not None, kernels="xla")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL)
