"""Inputs of the quantized K/V commit (``kernels.commit_paged`` with
``qmax``) in the shapes that test its page grouping, made with numpy from
a seed so that the JAX package's ``quant_line_write`` and the port see
the same bytes: tests/test_torch_commit_cases.py holds the port to JAX on
the CPU, tests/test_torch_cuda.py the commit kernel to the port's plain
version on the card.

Each slot owns its pages (pages are slot-private, as the page table
gives them); physical page P, the pool's last, is the scratch page where
padding lines point, and results are compared on pages [0, P) only.
"""
import numpy as np

PS, KV = 8, 2

#: name: (R, C, pages a slot owns, pages no slot owns); every case but
#: "whole-pool" takes quant_line_write's per-line branch (R * C < P + 1)
CASES = {
    # a slot's lines in a random order: a page's lines neither contiguous
    # nor sorted, across chunks of 32 lines
    "unsorted": (3, 40, 6, 110),
    # each page's lines spread through the chunk (line i at position
    # order i mod 5), so every page's lines sit in both warp chunks
    "split-page": (2, 40, 6, 80),
    # two lines at offset 0 of one page (equal values, so the write order
    # does not matter), and a page reset in the middle of another chunk
    "two-resets": (2, 6, 2, 20),
    # slot 1 idle (every line on the scratch page), and slot 2's last line
    # a padding line
    "idle-slot": (3, 5, 2, 20),
    # quant_line_write's whole-pool branch (R * C >= P + 1) over more than
    # 1024 pages, a third of the untouched ones at scale 0
    "whole-pool": (2, 600, 76, 948),
}


def make(name, quant, dk, seed=0):
    """One case: dict of numpy arrays k_pool, v_pool (P + 1, PS, KV, dk /
    pack) codes, k_scale, v_scale (P + 1, KV) f32, phys and off (R, C)
    int64, k and v (R, C, KV, dk) f32 (scaled to move some page scales),
    and P, the scratch page."""
    R, C, own, extra = CASES[name]
    rng = np.random.default_rng(seed + 7 * len(name) + dk)
    P = R * own + extra
    pack = 2 if quant == "int4" else 1
    shape = (P + 1, PS, KV, dk // pack)
    if quant == "int8":
        pools = [rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2)]
    else:
        pools = [rng.integers(0, 256, size=shape).astype(np.uint8) for _ in range(2)]
    scales = [(rng.random((P + 1, KV)) * 0.05 + 1e-3).astype(np.float32) for _ in range(2)]
    pages = rng.permutation(P)  # slot r owns pages[r * own:(r + 1) * own]
    start = rng.integers(0, PS, size=R)
    start[0] = 0  # slot 0's first line resets its page's scale
    pos = start[:, None] + np.arange(C)[None, :]
    assert pos.max() < own * PS
    if name == "unsorted":
        pos = np.stack([rng.permutation(p) for p in pos])
    elif name == "split-page":
        pos = np.stack([p[np.argsort(p % 5, kind="stable")] for p in pos])
    elif name == "two-resets":
        pos[0] = [0, 0, 1, 2, 3, 4]
        pos[1] = np.arange(PS - 2, PS + 4)
    phys = pages.reshape(-1)[:R * own].reshape(R, own)[np.arange(R)[:, None], pos // PS]
    off = pos % PS
    k, v = (rng.normal(size=(R, C, KV, dk)).astype(np.float32) * 0.6 for _ in range(2))
    if name == "two-resets":
        k[0, 1], v[0, 1] = k[0, 0], v[0, 0]
    if name == "idle-slot":
        phys[1] = P
        off[1] = rng.integers(0, PS, size=C)
        phys[2, -1], off[2, -1] = P, 3
    if name == "whole-pool":
        untouched = np.setdiff1d(np.arange(P), phys)
        zero = rng.choice(untouched, size=len(untouched) // 3, replace=False)
        for s in scales:
            s[zero] = 0.0
        assert R * C >= P + 1 > 1024
    return dict(k_pool=pools[0], v_pool=pools[1], k_scale=scales[0], v_scale=scales[1],
                phys=phys.astype(np.int64), off=off.astype(np.int64), k=k, v=v, P=P,
                qmax=127.0 if quant == "int8" else 7.0)
