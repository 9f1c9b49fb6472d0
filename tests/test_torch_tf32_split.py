"""Why the f32 mixed-step tile of the paged kernels ("tf32x3") splits both
of its products into three TF32 products: a plain emulation of the
tensor-core arithmetic on the CPU, held against the port's f32 plain
version ``ragged_paged_attention_ref``.

The emulation rounds each operand as ``cvt.rna.tf32.f32`` does (to 10
mantissa bits, ties away from zero, through the int32 view), multiplies
exactly (two TF32 significands fit in f32's) and sums in f32. At C 128
query rows, S 2048 cache lines and dk 64 or 128 it shows that

* 3xTF32 on both products (each operand split into TF32 hi + lo; lo * hi
  and hi * lo, then hi * hi) stays within the f32 kernels' tolerance of
  1e-5 with a margin of ten in the emulation (whose error is ~2e-7);
* one TF32 product, or a split of QK^T or of PV alone, misses it;
* every int8 and int4 code is exact in TF32, so on quantized pools only q
  and the probabilities split (two products each) and stay within it.

These are statements about the arithmetic with IEEE f32 sums, not about
the kernel's margin: ``mma.sync`` sums its products in its own way, so
the kernel on the card may sit closer to the tolerance than the
emulation does. ``tests/test_torch_cuda.py`` holds the kernel itself to
1e-5, and ``scripts/tf32_error_probe.py`` measures its error on a GPU.
"""
import math

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import kv_quant as kq

TOL = 1e-5      # the f32 kernels' tolerance against their plain versions
MARGIN = 10.0   # the emulated 3xTF32 must stay this far inside it
C, S, PS = 128, 2048, 128


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, split_a: bool, split_b: bool) -> torch.Tensor:
    """a @ b in TF32 products with f32 sums: an operand that splits enters
    as hi + lo (each TF32), one that does not as its TF32 rounding; the
    small products are summed before the large one."""
    ah = tf32(a)
    bh = tf32(b)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    if split_a:
        out = out + tf32(a - ah) @ bh
    if split_b:
        out = out + ah @ tf32(b - bh)
    return out + ah @ bh


def emulate(q, k, v, mask, scale, split_qk, split_pv, exact_kv=False, ks=None, vs=None):
    """One (slot, head) of attention, q (C, dk) against k, v (S, dk) under
    mask (C, S), its products as ``product`` computes them. With
    ``exact_kv`` k and v are TF32 already (quantized codes), so only q and
    p split; ``ks``/``vs`` (S,) are the lines' K and V page scales."""
    s = product(q, k.T, split_qk, split_qk and not exact_kv)
    s = s * (scale if ks is None else ks[None, :] * scale)
    s = torch.where(mask, s, torch.tensor(tk.NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(dim=1, keepdim=True)), torch.tensor(0.0))
    l = p.sum(dim=1, keepdim=True).clamp_min(1e-20)
    if vs is not None:
        p = p * vs[None, :]
    return product(p, v, split_pv, split_pv and not exact_kv) / l


def _case(seed, dk, quant=None):
    """One slot of C rows, one KV head, S lines on S / PS shuffled pages of
    PS (the scratch page last), a mask that attends each (row, line) with
    probability 0.8, from numpy's generator."""
    rng = np.random.default_rng(seed)
    NP = S // PS
    q = torch.from_numpy(rng.standard_normal((1, C, 1, dk), dtype=np.float32))
    lines = torch.from_numpy(rng.standard_normal((2, NP + 1, PS, 1, dk), dtype=np.float32))
    table = torch.from_numpy(rng.permutation(NP).astype(np.int32))[None]
    mask = torch.from_numpy(rng.random((1, C, S)) < 0.8)
    if quant is None:
        return q, lines[0], lines[1], None, None, table, mask
    spec = kq.SPECS[quant]
    sc = lines.abs().amax(dim=(2, 4)) / spec.qmax + 1e-3                  # (2, NP + 1, 1)
    codes = torch.round(lines / sc[:, :, None, :, None]).clamp(-spec.qmax, spec.qmax)
    pools = kq.pack_codes(codes, spec.dtype, spec.pack)
    return q, pools[0], pools[1], sc[0].contiguous(), sc[1].contiguous(), table, mask


def _error(seed, dk, split_qk, split_pv, quant=None):
    """Max abs distance of the emulation from the f32 plain version."""
    q, kp, vp, ks, vs, table, mask = _case(seed, dk, quant)
    ref = tk.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    pack = kq.pool_pack(kp) if quant else 1
    k = kq.unpack_codes(tk.gather_pages(kp, table), pack)[0, :, 0]       # (S, dk)
    v = kq.unpack_codes(tk.gather_pages(vp, table), pack)[0, :, 0]
    line_ks = line_vs = None
    if quant:
        line_ks = ks[table[0].long(), 0].repeat_interleave(PS)
        line_vs = vs[table[0].long(), 0].repeat_interleave(PS)
    out = emulate(q[0, :, 0], k, v, mask[0], 1.0 / math.sqrt(dk), split_qk, split_pv,
                  exact_kv=quant is not None, ks=line_ks, vs=line_vs)
    return float((out - ref[0, :, 0]).abs().max())


@pytest.mark.parametrize("dk", [64, 128])
def test_3xtf32_on_both_products_holds_the_f32_tolerance(dk):
    errs = [_error(seed, dk, True, True) for seed in range(2)]
    assert max(errs) <= TOL / MARGIN, errs


@pytest.mark.parametrize("split_qk,split_pv", [(False, False), (True, False), (False, True)],
                         ids=["one-pass", "qk-split-only", "pv-split-only"])
@pytest.mark.parametrize("dk", [64, 128])
def test_one_tf32_pass_or_one_split_misses_the_f32_tolerance(dk, split_qk, split_pv):
    assert _error(0, dk, split_qk, split_pv) > TOL


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_codes_are_exact_in_tf32(quant):
    qmax = kq.SPECS[quant].qmax
    codes = torch.arange(-qmax - (quant == "int4"), qmax + 1, dtype=torch.float32)
    assert torch.equal(tf32(codes), codes)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_two_products_on_quantized_pools_hold_the_f32_tolerance(quant):
    assert _error(0, 128, True, True, quant) <= TOL / MARGIN
