"""The port's decode heads (flexflow_tpu_torch/serve/sampling.py) against
the JAX package's: the same mode choice, the same filtered logits, the
same greedy tokens. Drawn tokens cannot match (torch's noise is not
jax.random's), so the draws are checked for respecting the filters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import sampling as js
from flexflow_tpu_torch.serve import sampling as ts

torch.set_num_threads(1)

R, V = 6, 96


def _logits(seed):
    return np.random.default_rng(seed).normal(size=(R, V)).astype(np.float32) * 3


MODE_CASES = [
    # greedy, topp, topk
    ([True] * R, [2.0] * R, [0] * R),
    ([False, True, True, True, True, True], [2.0] * R, [0] * R),
    ([False, False, True, True, True, True], [2.0] * R, [5, 3, 0, 0, 0, 0]),
    ([False, False, True, True, True, True], [0.9, 2.0, 2.0, 2.0, 2.0, 2.0], [0] * R),
    ([False] * R, [2.0] * R, [200] * R),
    ([False] * R, [2.0] * R, [64, 1, 0, 2, 3, 4]),
]


@pytest.mark.parametrize("case", range(len(MODE_CASES)))
def test_choose_sample_mode_matches_jax(case):
    greedy, topp, topk = (np.asarray(a) for a in MODE_CASES[case])
    assert ts.choose_sample_mode(greedy, topp, topk, V) == js.choose_sample_mode(
        greedy, topp, topk, V)


def _jax_full_filter(logits, temp, topp, topk_arr):
    """The JAX package's "full" head up to the draw: temperature, the
    shared sort, the per-row top-k cut, then the top-p cut."""
    scaled = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temp), 1e-6)[:, None]
    sd = js._sorted_desc(scaled)
    scaled, sd = js._topk_filter(scaled, jnp.asarray(topk_arr), sd)
    return np.asarray(js._topp_filter(scaled, jnp.asarray(topp), sd))


FILTER_CASES = {
    # mode: (topp, topk) — every row samples
    "sample": ([2.0] * R, [0] * R),
    "topk": ([2.0] * R, [1, 2, 5, 0, 7, 3]),
    "full": ([0.5, 0.9, 2.0, 0.3, 0.99, 0.7], [0, 4, 0, 10, 2, 0]),
}


@pytest.mark.parametrize("mode", sorted(FILTER_CASES))
def test_filtered_logits_match_jax(mode):
    logits = _logits(1)
    topp, topk = (np.asarray(a) for a in FILTER_CASES[mode])
    topp = topp.astype(np.float32)
    topk = topk.astype(np.int32)
    temp = np.linspace(0.5, 1.5, R).astype(np.float32)
    greedy = np.zeros((R,), bool)
    got_mode, cap = ts.choose_sample_mode(greedy, topp, topk, V)
    assert got_mode == mode
    got = ts.filter_logits(
        torch.from_numpy(logits), temperature=torch.from_numpy(temp),
        topp=torch.from_numpy(topp), topk_arr=torch.from_numpy(topk),
        mode=mode, topk_cap=cap,
    ).numpy()
    # every mode serves the rows it is chosen for exactly like "full"
    want = _jax_full_filter(logits, temp, topp, topk)
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_topk_and_topp_filters_match_jax():
    logits = _logits(2)
    topk = np.asarray([0, 1, 3, 96, 5, 2], np.int32)
    topp = np.asarray([0.1, 0.5, 0.95, 2.0, 0.0, 0.7], np.float32)
    fj, fsj = js._topk_filter(jnp.asarray(logits), jnp.asarray(topk))
    ft, fst = ts._topk_filter(torch.from_numpy(logits), torch.from_numpy(topk))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(fst.numpy(), np.asarray(fsj))
    pj = js._topp_filter(jnp.asarray(logits), jnp.asarray(topp))
    pt = ts._topp_filter(torch.from_numpy(logits), torch.from_numpy(topp))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    aj = js._apply_topk(jnp.asarray(logits), 4)
    at = ts._apply_topk(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_greedy_tokens_match_jax():
    logits = _logits(3)
    greedy = np.ones((R,), bool)
    kw = dict(temperature=np.ones((R,), np.float32), topp=np.full((R,), 2.0, np.float32))
    want = js.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                            greedy=jnp.asarray(greedy),
                            temperature=jnp.asarray(kw["temperature"]),
                            topp=jnp.asarray(kw["topp"]), mode="greedy")
    got = ts.sample_tokens(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                           greedy=torch.from_numpy(greedy),
                           temperature=torch.from_numpy(kw["temperature"]),
                           topp=torch.from_numpy(kw["topp"]), mode="greedy")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draws_respect_the_filters_and_mix_with_greedy():
    logits = torch.from_numpy(_logits(4))
    greedy = torch.tensor([True, False, False, False, False, False])
    topk = torch.tensor([0, 1, 3, 3, 2, 5])
    topp = torch.full((R,), 2.0)
    temp = torch.ones(R)
    mode, cap = ts.choose_sample_mode(greedy.numpy(), topp.numpy(), topk.numpy(), V)
    gen = torch.Generator().manual_seed(0)
    allowed = torch.topk(logits, 5, dim=-1).indices
    for _ in range(50):
        toks = ts.sample_tokens(logits, gen, greedy=greedy, temperature=temp,
                                topp=topp, topk_arr=topk, mode=mode, topk_cap=cap)
        assert toks[0] == logits[0].argmax()
        assert toks[1] == logits[1].argmax()  # top-1 leaves one choice
        for r in range(2, R):
            assert toks[r] in allowed[r, : int(topk[r])]
