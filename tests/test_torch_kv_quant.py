"""The port's quantized-page write side (flexflow_tpu_torch/serve/kv_quant.py)
held bit for bit against the JAX package's on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import kv_quant as jq
from flexflow_tpu_torch.serve import kv_quant as tq

torch.set_num_threads(1)

P1, PS, KV, DK = 9, 8, 2, 16  # 8 pages + the scratch page


def _pool(rng, name):
    if name == "int8":
        return rng.integers(-127, 128, size=(P1, PS, KV, DK)).astype(np.int8)
    return rng.integers(0, 256, size=(P1, PS, KV, DK // 2)).astype(np.uint8)


# R * C = 6 < P+1 takes the per-line page gather; 32 >= P+1 the full pool
@pytest.mark.parametrize("R,C", [(2, 3), (4, 8)])
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quant_line_write_equals_jax_bitwise(name, R, C):
    """Codes and scales equal JAX's exactly (tolerance: none), given the
    same f32 lines: offset-0 resets, pages written twice in one call,
    zero-scale pages and growing scales all occur."""
    rng = np.random.default_rng(11)
    spec = jq.SPECS[name]
    for _ in range(6):
        kq = _pool(rng, name)
        scale = (rng.random((P1, KV)) * 0.05).astype(np.float32)
        scale[0] = 0.0
        phys = rng.integers(0, P1, size=(R, C)).astype(np.int32)
        off = rng.integers(0, PS, size=(R, C)).astype(np.int32)
        off[0, 0] = 0
        vals = (rng.normal(size=(R, C, KV, DK)) * rng.random() * 3).astype(np.float32)
        want_q, want_s = jq.quant_line_write(
            jnp.asarray(kq), jnp.asarray(scale), jnp.asarray(phys),
            jnp.asarray(off), jnp.asarray(vals), spec.qmax)
        got_q, got_s = torch.from_numpy(kq.copy()), torch.from_numpy(scale.copy())
        out = tq.quant_line_write(got_q, got_s, torch.from_numpy(phys),
                                  torch.from_numpy(off), torch.from_numpy(vals),
                                  tq.SPECS[name].qmax)
        assert out[0] is got_q and out[1] is got_s  # updated in place
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                      np.asarray(want_s).view(np.int32))


def test_nibble_pack_unpack_round_trip_and_layout():
    rng = np.random.default_rng(12)
    codes = rng.integers(-8, 8, size=(3, 5, DK)).astype(np.float32)
    packed = tq.pack_nibbles(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, DK // 2)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(tq.unpack_nibbles(packed).numpy(), codes)
    # byte j: code j in the low nibble, code j + dk/2 in the high one, +8
    assert int(packed[0, 0, 1]) == (int(codes[0, 0, 1]) + 8) | ((int(codes[0, 0, 1 + DK // 2]) + 8) << 4)
    # an all-zero byte decodes to -8 (a zero page scale maps it to 0)
    assert (tq.unpack_nibbles(torch.zeros(1, 4, dtype=torch.uint8)) == -8).all()


def test_quantized_pool_pages_and_specs_equal_jax():
    for name in ("int8", "int4"):
        js, ts = jq.SPECS[name], tq.SPECS[name]
        assert (ts.qmax, ts.pack, ts.itemsize, ts.bits) == (js.qmax, js.pack, js.itemsize, js.bits)
        for fp_pages, ps, kv, dk, isz in [(17, 128, 32, 128, 2), (6, 8, 2, 16, 4), (40, 16, 8, 64, 2)]:
            assert tq.quantized_pool_pages(fp_pages, ps, kv, dk, isz, ts) == \
                jq.quantized_pool_pages(fp_pages, ps, kv, dk, isz, js)
    assert tq.page_bytes(128, 32, 128, 2) == jq.page_bytes(128, 32, 128, 2)
    assert tq.resolve_spec(None) is None
    with pytest.raises(ValueError, match="unknown kv_quant"):
        tq.resolve_spec("int3")
