"""The port's PageAllocator (flexflow_tpu_torch/serve/paging.py) driven in
lockstep with the JAX package's by one random sequence of operations."""
import numpy as np
import pytest

from flexflow_tpu.serve.paging import PageAllocator as JaxPageAllocator
from flexflow_tpu_torch.serve import PageAllocator


def _state(pa, free):
    return pa.table.copy(), pa.refcount.copy(), list(free), pa.version


@pytest.mark.parametrize("seed", [0, 1])
def test_random_ensure_release_cow_matches_jax(seed):
    rng = np.random.default_rng(seed)
    args = dict(num_pages=12, pages_per_slot=4, num_slots=4, page_size=8)
    ja, pa = JaxPageAllocator(**args), PageAllocator(**args)
    for _ in range(400):
        op = rng.choice(["ensure", "ensure", "release", "cow"])
        slot = int(rng.integers(0, 4))
        if op == "ensure":
            lines = int(rng.integers(0, 33))
            assert pa.ensure(slot, lines) == ja.ensure(slot, lines)
        elif op == "release":
            assert pa.release(slot) == ja.release(slot)
        else:
            mapped = np.flatnonzero(pa.table[slot] != pa.scratch_page)
            if len(mapped) == 0:
                continue
            logical = int(rng.choice(mapped))
            assert pa.cow(slot, logical) == ja.cow(slot, logical)
        want = _state(ja, ja._free_by_shard[0])
        got = _state(pa, pa._free)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
        assert (pa.free_pages, pa.used_pages) == (ja.free_pages, ja.used_pages)
    pa.check_no_leaks()
    ja.check_no_leaks()


def test_exhaustion_is_all_or_nothing_and_small_pools_rejected():
    pa = PageAllocator(4, 4, 2, 16)
    assert pa.ensure(0, 3 * 16)
    before = pa.table.copy()
    assert not pa.ensure(1, 2 * 16)  # needs 2, 1 free
    np.testing.assert_array_equal(pa.table, before)
    assert pa.free_pages == 1
    assert pa.ensure(1, 16)          # the last free page
    assert pa.cow(0, 0) is None      # pool dry: the table is unchanged
    assert pa.table[0, 0] == before[0, 0]
    pa.check_no_leaks()
    with pytest.raises(ValueError, match="smaller than one request"):
        PageAllocator(2, 4, 2, 16)
