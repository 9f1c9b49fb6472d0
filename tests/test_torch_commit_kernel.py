"""The unfused quantized paged commit (flexflow_tpu_torch/serve/kernels.py
``commit_paged`` with ``qmax``) on the CPU: bitwise
``kv_quant.quant_line_write`` on K and on V in both of its branches, with
``kernels="cuda"`` (CPU tensors take the plain version) and
``kernels="torch"``; and the rule the commit kernel's whole-pool sweep
follows (csrc/paged_commit.cu), read from quant_line_write itself. The
kernel runs only on a GPU (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import kv_quant as tq

torch.set_num_threads(1)

PS, KV, DK = 8, 2, 16


def _pools(rng, name, P1):
    if name == "int8":
        codes = rng.integers(-127, 128, size=(2, P1, PS, KV, DK)).astype(np.int8)
    else:
        codes = rng.integers(0, 256, size=(2, P1, PS, KV, DK // 2)).astype(np.uint8)
    scales = (rng.random((2, P1, KV)) * 0.05).astype(np.float32)
    scales[:, 0] = 0.0  # a page never written
    return [torch.from_numpy(x) for x in codes], [torch.from_numpy(x) for x in scales]


def _lines(rng, R, C, P1, dtype):
    phys = torch.from_numpy(rng.integers(1, P1, size=(R, C)))
    off = torch.from_numpy(rng.integers(0, PS, size=(R, C)))
    off[0, 0] = 0  # an offset-0 reset
    k, v = (torch.from_numpy(rng.normal(size=(R, C, KV, DK)).astype(np.float32)).to(dtype)
            for _ in range(2))
    return phys, off, k, v


# R * C = 6 < P+1 = 9: the per-line page gather; R * C = 24 >= 9: the pool
@pytest.mark.parametrize("R,C", [(2, 3), (3, 8)], ids=["per-line", "whole-pool"])
@pytest.mark.parametrize("kernels", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_commit_paged_on_cpu_is_quant_line_write(name, dtype, kernels, R, C):
    """Codes and scales of both pools bit for bit those of
    quant_line_write run on K and then on V; nothing counted as a
    launch."""
    rng = np.random.default_rng(3)
    qmax = tq.SPECS[name].qmax
    (kq, vq), (ks, vs) = _pools(rng, name, 9)
    phys, off, k, v = _lines(rng, R, C, 9, dtype)
    want = [t.clone() for t in (kq, vq, ks, vs)]
    tq.quant_line_write(want[0], want[2], phys, off, k, qmax)
    tq.quant_line_write(want[1], want[3], phys, off, v, qmax)
    before = dict(tk.LAUNCHES)
    tk.commit_paged(kq, vq, k, v, phys, off, ks, vs, qmax, kernels=kernels)
    for got, w in zip((kq, vq, ks, vs), want):
        assert torch.equal(got, w)
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_whole_pool_branch_is_per_line_branch_plus_zeroed_untouched_pages(name):
    """What the commit kernel's sweep blocks do, read from the plain
    version: at R * C >= P+1 quant_line_write equals its per-line branch
    (the same call on the pool padded with pages no line touches, so
    that R * C < P+1) except on the pages no line touches whose scale is
    0, whose codes become rint(code * 0) = 0 (int8 byte 0, int4 byte
    0x88); the untouched pages with a scale keep their codes."""
    rng = np.random.default_rng(4)
    qmax = tq.SPECS[name].qmax
    P1, R, C = 9, 2, 6  # R * C = 12 >= 9
    (kq, _), (ks, _) = _pools(rng, name, P1)
    ks[4] = 0.0  # a second scale-0 page, if no line touches it
    phys, off, k, _ = _lines(rng, R, C, P1, torch.float32)
    pad = R * C - P1 + 1
    big_q = torch.cat([kq, torch.zeros((pad,) + kq.shape[1:], dtype=kq.dtype)])
    big_s = torch.cat([ks, torch.ones(pad, KV)])
    tq.quant_line_write(big_q, big_s, phys, off, k, qmax)  # per-line branch
    untouched = torch.ones(P1, dtype=torch.bool)
    untouched[phys.reshape(-1)] = False
    zeroed = untouched[:, None] & (ks == 0)  # (page, head)
    tq.quant_line_write(kq, ks, phys, off, k, qmax)          # whole-pool branch
    assert torch.equal(ks, big_s[:P1])
    zero = 0x88 if name == "int4" else 0
    for page in range(P1):
        for h in range(KV):
            got, per_line = kq[page, :, h], big_q[page, :, h]
            if zeroed[page, h]:
                assert (got.to(torch.int32) == zero).all()
            else:
                assert torch.equal(got, per_line)
    assert zeroed.any() and (untouched[:, None] & (ks > 0)).any()


def test_commit_paged_rejects_unknown_kernels():
    rng = np.random.default_rng(5)
    (kq, vq), (ks, vs) = _pools(rng, "int8", 9)
    phys, off, k, v = _lines(rng, 1, 2, 9, torch.float32)
    with pytest.raises(ValueError, match="unknown kernels"):
        tk.commit_paged(kq, vq, k, v, phys, off, ks, vs, 127.0, kernels="bogus")
