"""The port's serving entry points on the CPU: the HF checkpoint loader
(``models/hf_utils.py``: its own safetensors reader, the ``.bin``
fallback), llama's ``from_hf`` and ``convert_hf_state_dict``,
``LLM.from_pretrained`` and ``detect_family``, ``generate_stream`` and
the ``python -m flexflow_tpu_torch serve`` command, against the JAX
package on tiny ``transformers`` checkpoints built here from a seed."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.models import hf_utils as jhf
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve.llm import LLM as JaxLLM
from flexflow_tpu_torch.models import hf_utils, llama as tl
from flexflow_tpu_torch.serve import ServingConfig, SpecConfig
from flexflow_tpu_torch.serve.llm import LLM, detect_family
from flexflow_tpu_torch.serve.specinfer import SpecInferManager

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[3, 17, 91, 42, 7], list(range(20, 31)), [5, 6]]
SERVE = dict(max_requests_per_batch=4, max_sequence_length=64, prefill_chunk=8,
             max_spec_tree_tokens=16)


def _hf_model(tied: bool, seed: int = 0):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-6, tie_word_embeddings=tied)
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(cfg)
    with torch.no_grad():  # norms away from 1, so a wrong mapping shows
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn_like(p))
    return model


def _save(tmp_path_factory, kind):
    tied = kind.startswith("tied")
    safe = kind.endswith("safetensors")
    d = tmp_path_factory.mktemp(kind)
    _hf_model(tied).save_pretrained(d, safe_serialization=safe)
    return str(d), tied, safe


@pytest.fixture(scope="module", params=["untied-safetensors", "tied-safetensors", "untied-bin",
                                        "tied-bin"])
def checkpoint(request, tmp_path_factory):
    return _save(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def untied(tmp_path_factory):
    """The checkpoint of the streaming and command-line cases."""
    return _save(tmp_path_factory, "untied-safetensors")[0]


def test_checkpoint_files(checkpoint):
    d, _, safe = checkpoint
    names = os.listdir(d)
    assert any(n.endswith(".safetensors") for n in names) == safe
    assert any(n.startswith("pytorch_model") for n in names) != safe


def test_from_hf_and_convert_match_jax(checkpoint):
    """from_hf gives JAX's config fields; convert_hf_state_dict gives JAX's
    f32 parameter tree bit for bit (transposed Linear weights, stacked
    layers, no lm_head when tied)."""
    d, tied, _ = checkpoint
    hf = hf_utils.load_hf_config(d)
    cfg_t = tl.from_hf(hf, dtype=torch.float32)
    cfg_j = jl.from_hf(hf, dtype=jnp.float32)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "rms_norm_eps", "rope_theta",
              "max_position_embeddings", "tie_word_embeddings"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    assert cfg_t.tie_word_embeddings == tied
    got = tl.convert_hf_state_dict(hf_utils.load_state_dict(d), cfg_t, device="cpu")
    want = jl.convert_hf_state_dict(jhf.load_state_dict(d), cfg_j)
    assert ("lm_head" in got) == (not tied) == ("lm_head" in want)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, flat_g)) == sorted(map(str, flat_w))
    for k, v in flat_w.items():
        g = flat_g[k]
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=str(k))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_safetensors_reader_bitwise(tmp_path, dtype):
    """The port's reader against safetensors.torch.load_file, bit for bit,
    across several shard files and scalar and empty tensors."""
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(1)
    shards = [{"a.w": torch.randn(3, 5, generator=g).to(dtype),
               "b": torch.randn(7, generator=g).to(dtype)},
              {"c.x": torch.randn(2, 3, 4, generator=g).to(dtype),
               "s": torch.tensor(2.5).to(dtype), "e": torch.empty(0, 4, dtype=dtype),
               "i": torch.arange(6, dtype=torch.int64).reshape(2, 3)}]
    for n, shard in enumerate(shards):
        st.save_file(shard, str(tmp_path / f"model-0000{n + 1}-of-00002.safetensors"),
                     metadata={"format": "pt"})
    got = hf_utils.load_state_dict(str(tmp_path))
    want = {}
    for n in range(2):
        want.update(st.load_file(str(tmp_path / f"model-0000{n + 1}-of-00002.safetensors")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           want[k].reshape(-1).view(torch.uint8)), k


def test_load_state_dict_without_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError):
        hf_utils.load_state_dict(str(tmp_path))


def test_detect_family():
    assert detect_family({"model_type": "llama"}) is tl
    assert detect_family({"architectures": ["LlamaForCausalLM"]}) is tl
    for later in ({"model_type": "mistral"}, {"architectures": ["Qwen2MoeForCausalLM"]},
                  {"model_type": "gpt_bigcode"}):
        with pytest.raises(NotImplementedError, match="queue 1 item 4"):
            detect_family(later)
    with pytest.raises(ValueError, match="unsupported"):
        detect_family({"model_type": "bogus", "architectures": ["BogusLM"]})


def test_entry_points_default_to_the_gpu(checkpoint, monkeypatch):
    """from_pretrained, convert_hf_state_dict and the serve command run on
    "cuda" unless asked for another device, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = checkpoint[0]
    with pytest.raises(RuntimeError, match="no.*GPU|none is available"):
        LLM.from_pretrained(d)
    with pytest.raises(RuntimeError, match="none is available"):
        tl.convert_hf_state_dict(hf_utils.load_state_dict(d), tl.from_hf(
            hf_utils.load_hf_config(d)))
    from flexflow_tpu_torch import __main__ as cli

    with pytest.raises(RuntimeError, match="none is available"):
        cli.main(["serve", "--model-dir", d, "--max-new-tokens", "2"])


def test_from_pretrained_tokens_match_jax(checkpoint):
    """Greedy tokens of LLM.from_pretrained(device="cpu") equal JAX's
    LLM.from_pretrained on the same checkpoint (f32)."""
    d = checkpoint[0]
    port = LLM.from_pretrained(d, dtype=torch.float32, device="cpu")
    assert port.tokenizer is None  # no tokenizer files in the directory
    port.compile(ServingConfig(cache_dtype=torch.float32, kernels="cuda", **SERVE))
    got = [r.output_tokens for r in port.generate(PROMPTS, max_new_tokens=8)]
    jax_llm = JaxLLM.from_pretrained(d, dtype=jnp.float32, tokenizer=None)
    jax_llm.compile(JaxServingConfig(cache_dtype=jnp.float32, kernels="xla", **SERVE))
    want = [r.output_tokens for r in jax_llm.generate(PROMPTS, max_new_tokens=8)]
    assert got == want and all(len(t) == 8 for t in got)


def test_from_pretrained_loads_a_local_tokenizer(tmp_path):
    """With tokenizer files in the directory, tokenizer="auto" loads them
    (local files only) and text prompts serve; without them it is None and
    transformers is not asked."""
    tokenizers = pytest.importorskip("tokenizers")
    d = tmp_path / "with-tokenizer"
    _hf_model(False).save_pretrained(d, safe_serialization=True)
    vocab = {w: i for i, w in enumerate(["[UNK]", "hello", "world"])}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok).save_pretrained(d)
    port = LLM.from_pretrained(str(d), dtype=torch.float32, device="cpu")
    assert port.tokenizer is not None
    assert port.tokenizer.encode("hello world") == [1, 2]
    port.compile(ServingConfig(cache_dtype=torch.float32, **SERVE))
    out = port.generate("hello world", max_new_tokens=3)[0]
    assert out.input_tokens == [1, 2] and len(out.output_tokens) == 3
    assert out.output_text == port.tokenizer.decode(out.output_tokens)


def _stream_by_request(events):
    """Per request: its tokens, and whether exactly one terminal event
    came right after its last token."""
    tokens, done = {}, {}
    for e in events:
        assert e.request_id not in done, "an event after the request's terminal event"
        if e.done:
            assert e.token is None and e.error is None
            done[e.request_id] = True
        else:
            tokens.setdefault(e.request_id, []).append(e.token)
    return tokens, done


@pytest.mark.parametrize("manager", ["incremental", "spec"])
def test_generate_stream_equals_generate_and_jax(untied, manager):
    """generate_stream yields each request's generate tokens in order, then
    one terminal event; on the base manager and on SpecInferManager; and
    the same per-request streams as JAX's generate_stream."""
    d = untied
    port = LLM.from_pretrained(d, dtype=torch.float32, device="cpu")
    sc = ServingConfig(cache_dtype=torch.float32, **SERVE)
    spec = (SpecConfig(2, 3, draft="early_exit", draft_layers=1) if manager == "spec"
            else None)
    port.compile(sc, spec=spec)
    want = [r.output_tokens for r in port.generate(PROMPTS, max_new_tokens=8)]
    port.compile(sc, spec=spec)
    assert isinstance(port.rm, SpecInferManager) == (manager == "spec")
    events = list(port.rm.generate_stream(PROMPTS, max_new_tokens=8))
    tokens, done = _stream_by_request(events)
    rids = sorted(done)
    assert len(rids) == len(PROMPTS)
    assert [tokens[r] for r in rids] == want
    assert sum(e.done for e in events) == len(PROMPTS)
    jax_llm = JaxLLM.from_pretrained(d, dtype=jnp.float32, tokenizer=None)
    jax_llm.compile(JaxServingConfig(cache_dtype=jnp.float32, kernels="xla", **SERVE))
    jtokens, jdone = _stream_by_request(
        jax_llm.rm.generate_stream(PROMPTS, max_new_tokens=8))
    assert [jtokens[r] for r in sorted(jdone)] == want


def test_serve_command_subprocess(untied):
    """python -m flexflow_tpu_torch serve --device cpu --kernels torch over
    the checkpoint exits 0 and prints the tokens of from_pretrained's
    generate, each with a profile line."""
    d = untied
    prompts = ["3,17,91,42,7", "20 21 22"]
    port = LLM.from_pretrained(d, device="cpu")
    port.compile(ServingConfig(max_requests_per_batch=4, max_sequence_length=512,
                               kernels="torch", cache_dtype=port.cfg.dtype))
    want = [r.output_tokens for r in port.generate([[3, 17, 91, 42, 7], [20, 21, 22]],
                                                   max_new_tokens=6)]
    cmd = [sys.executable, "-m", "flexflow_tpu_torch", "serve", "--model-dir", d,
           "--device", "cpu", "--kernels", "torch", "--max-new-tokens", "6"]
    for p in prompts:
        cmd += ["--prompt", p]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [json.loads(line) for line in lines[0::2]] == want
    assert all(line.startswith("  [steps=") for line in lines[1::2])
