"""The port's CUDA attention kernels held against their plain PyTorch
versions on the GPU. Every test here needs a CUDA GPU and skips without
one; the file imports neither JAX nor the JAX package, so on a machine
with a GPU and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import pytest
import torch

from flexflow_tpu_torch.serve import kernels as tk

# bf16: kernel and plain version both compute in f32 and round the output
# once, so they may differ by one bf16 ulp (<= 2^-7 |x|); f32: summation
# order only
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, dk):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    R, S1, H, KV, C = 3, 300, 8, 2, 16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v = rnd(R, H, dk), rnd(R, S1, KV, dk), rnd(R, S1, KV, dk)
    sl = torch.tensor([0, 1, 299], dtype=torch.int32, device=cuda_device)
    before = dict(tk.LAUNCHES)
    out = tk.decode_attention(q, k, v, sl)
    torch.testing.assert_close(out, tk.decode_attention_ref(q, k, v, sl), **TOL[dtype])
    assert (out[0] == 0).all()  # a zero-length slot gives zeros
    qc = rnd(R, C, H, dk)
    pos = torch.arange(C, device=cuda_device)[None, :] + torch.tensor(
        [[0], [100], [S1 - 1 - C]], device=cuda_device)
    mask = tk.causal_serve_mask(pos, S1)
    mask[0, 2] = False  # a fully masked row gives zeros
    out = tk.verify_attention(qc, k, v, mask)
    torch.testing.assert_close(out, tk.verify_attention_ref(qc, k, v, mask), **TOL[dtype])
    assert (out[0, 2] == 0).all()
    assert tk.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert tk.LAUNCHES["verify_attention"] == before["verify_attention"] + 1


def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    R, S1, H, KV, dk = 2, 40, 4, 2, 32  # no kernel for head dim 32
    q = torch.zeros(R, H, dk, device=cuda_device)
    kv = torch.zeros(R, S1, KV, dk, device=cuda_device)
    sl = torch.ones(R, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tk.decode_attention(q, kv, kv, sl)
    q, kv = q[..., :16].to(torch.float16), kv[..., :16].to(torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.verify_attention(q[:, None], kv, kv,
                            torch.ones(R, 1, S1, dtype=torch.bool, device=cuda_device))
