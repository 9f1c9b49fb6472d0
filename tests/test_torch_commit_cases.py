"""The quantized K/V commit (flexflow_tpu_torch/serve/kernels.py
``commit_paged`` with ``qmax``) held against the JAX package's
``quant_line_write`` (flexflow_tpu/serve/kv_quant.py), run on K and on V,
in the shapes that test the commit kernel's page grouping
(tests/commit_cases.py): unsorted lines, a page's lines spread through
the chunk, two lines at offset 0 of one page, an idle slot on the scratch
page, the whole-pool branch over more than 1024 pages; int8 and int4,
head dims 64 and 80, f32 and bf16 lines, phys and off as int64 and int32.
Pools and scales are compared bit for bit on every page but the scratch
page. On CPU tensors ``commit_paged`` runs its plain version; the same
cases hold the kernel to that version on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import commit_cases as cc
from flexflow_tpu.serve import kv_quant as jq
from flexflow_tpu_torch.serve import kernels as tk

torch.set_num_threads(1)


def _jax_commit(c, k, v):
    """quant_line_write of JAX on K and on V: numpy pools and scales."""
    phys, off = jnp.asarray(c["phys"], jnp.int32), jnp.asarray(c["off"], jnp.int32)
    out = []
    for pool, scale, x in ((c["k_pool"], c["k_scale"], k), (c["v_pool"], c["v_scale"], v)):
        q, s = jq.quant_line_write(jnp.asarray(pool), jnp.asarray(scale), phys, off, x,
                                   c["qmax"])
        out.append((np.asarray(q), np.asarray(s)))
    return out


def _lines(c, dtype):
    """K and V lines in ``dtype``, as JAX and as torch arrays of the same
    values (bf16 rounds the f32 values to nearest even in both)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jk, jv = jnp.asarray(c["k"]).astype(jdt), jnp.asarray(c["v"]).astype(jdt)
    tk_, tv = (torch.from_numpy(c[n]).to(dtype) for n in ("k", "v"))
    return (jk, jv), (tk_, tv)


def _port_commit(c, k, v, index_dtype):
    pools = [torch.from_numpy(c[n].copy()) for n in ("k_pool", "v_pool", "k_scale", "v_scale")]
    phys, off = (torch.from_numpy(c[n]).to(index_dtype) for n in ("phys", "off"))
    tk.commit_paged(pools[0], pools[1], k, v, phys, off, pools[2], pools[3], c["qmax"])
    return pools


@pytest.mark.parametrize("case", list(cc.CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dk", [64, 80])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_commit_paged_bitwise_jax_quant_line_write(quant, dk, dtype, case):
    c = cc.make(case, quant, dk)
    (jk, jv), (k, v) = _lines(c, dtype)
    (kq, ks), (vq, vs) = _jax_commit(c, jk, jv)
    got = _port_commit(c, k, v, torch.int64)
    P = c["P"]
    for x, want in zip(got, (kq, vq, ks, vs)):
        assert np.array_equal(x.numpy()[:P], want[:P])
    # the step moved codes and scales (the case is not a no-op)
    assert not np.array_equal(got[2].numpy()[:P], c["k_scale"][:P])


@pytest.mark.parametrize("case", ["unsorted", "whole-pool"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_commit_paged_int32_and_int64_indices_give_the_same_bytes(quant, case):
    """phys and off as int32 give the bytes int64 gives (the unfused step
    passes int64, a fused caller's lines int32), and both are JAX's."""
    c = cc.make(case, quant, 80)
    (jk, jv), (k, v) = _lines(c, torch.float32)
    wide, narrow = _port_commit(c, k, v, torch.int64), _port_commit(c, k, v, torch.int32)
    (kq, ks), (vq, vs) = _jax_commit(c, jk, jv)
    P = c["P"]
    for a, b, want in zip(wide, narrow, (kq, vq, ks, vs)):
        assert torch.equal(a, b)
        assert np.array_equal(a.numpy()[:P], want[:P])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_whole_pool_case_zeroes_untouched_zero_scale_pages(quant):
    """The whole-pool case reaches what the kernel's sweep blocks do:
    JAX's result on an untouched page of scale 0 is zero codes (int8 byte
    0, int4 byte 0x88), on an untouched page with a scale its codes as
    they were."""
    c = cc.make("whole-pool", quant, 64)
    (jk, jv), _ = _lines(c, torch.float32)
    (kq, ks), _ = _jax_commit(c, jk, jv)
    P = c["P"]
    untouched = np.setdiff1d(np.arange(P), c["phys"])
    zero = 0x88 if quant == "int4" else 0
    swept = kept = 0
    for page in untouched:
        for h in range(cc.KV):
            if c["k_scale"][page, h] == 0.0:
                assert (kq[page, :, h].view(np.uint8) == zero).all()
                swept += 1
            else:
                assert np.array_equal(kq[page, :, h], c["k_pool"][page, :, h])
                kept += 1
    assert swept > 0 and kept > 0
