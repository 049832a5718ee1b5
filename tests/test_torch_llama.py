"""The port's Llama forward against ``zoo_tpu``'s ``Llama.call`` on the
same weights (converted with ``params_from_jax``), within 1e-4 absolute
on the logits: f32 sums over at most 64 terms per product, taken in
another order than XLA's, through two blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.models.llm.llama import Llama as JaxLlama
from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.models.llm.llama import apply_rope as jax_apply_rope
from zoo_tpu.models.llm.llama import _rms_norm as jax_rms_norm
from zoo_tpu.models.llm.llama import llama3_8b_config as jax_8b
from zoo_tpu.models.llm.llama import llama_param_count as jax_count
from zoo_tpu.models.llm.llama import rope_frequencies as jax_rope

from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm import llama as tl

jax.config.update("jax_platforms", "cpu")

CFG = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
           intermediate=64, rope_theta=10000.0)


@pytest.fixture(scope="module")
def jax_model():
    cfg = JaxConfig(**CFG)
    layer = JaxLlama(cfg, lm_head=True)
    params = layer.build(jax.random.PRNGKey(0), (None, 16))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, layer, params, tree


@pytest.mark.parametrize("T", [5, 16])
def test_llama_logits_match_jax(jax_model, T):
    cfg, layer, params, tree = jax_model
    ids = np.random.RandomState(T).randint(0, cfg.vocab, (2, T))
    ref = np.asarray(layer.call(params, jnp.asarray(ids, jnp.int32)))
    model = tl.Llama(tl.LlamaConfig(**CFG), params_from_jax(tree, "cpu"))
    out = model(torch.from_numpy(ids))
    assert model.last_attention_impl == "dense"
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_param_tree_round_trips(jax_model):
    """params_from_jax keeps the JAX layout leaf for leaf."""
    _, _, _, tree = jax_model
    params = params_from_jax(tree, "cpu")
    model = tl.Llama(tl.LlamaConfig(**CFG), params)
    got = model.params
    np.testing.assert_array_equal(got["embed"].numpy(), tree["embed"])
    for k in tl.BLOCK_KEYS:
        np.testing.assert_array_equal(got["blocks"][k].numpy(),
                                      tree["blocks"][k])
    np.testing.assert_array_equal(got["head"].numpy(), tree["head"])


def test_norm_and_rope_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 7, 32).astype(np.float32)
    g = rs.randn(32).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)),
        atol=1e-6)
    cos, sin = tl.rope_frequencies(16, 40, 500000.0)
    jcos, jsin = jax_rope(16, 40, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    xr = rs.randn(2, 3, 40, 16).astype(np.float32)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(xr), cos, sin).numpy(),
        np.asarray(jax_apply_rope(jnp.asarray(xr), jcos, jsin)), atol=1e-5)


def test_configs_and_param_count_match_jax():
    assert tl.llama3_8b_config().__dict__ == jax_8b().__dict__
    assert tl.llama_param_count(tl.llama3_8b_config()) == \
        jax_count(jax_8b())
    assert tl.llama3_8b_config().head_dim == 128


def test_build_from_seed_is_deterministic_with_jax_fans():
    cfg = tl.LlamaConfig(**CFG)
    a = tl.Llama.build(cfg, seed=3, device="cpu").params
    b = tl.Llama.build(cfg, seed=3, device="cpu").params
    assert torch.equal(a["blocks"]["wq"], b["blocks"]["wq"])
    assert a["blocks"]["wq"].shape == (2, 32, 32)
    assert a["blocks"]["wk"].shape == (2, 32, 16)
    lim = np.sqrt(6.0 / (32 + 64))     # glorot fans of (hidden, inter)
    assert float(a["blocks"]["w_gate"].abs().max()) <= lim
    assert float(a["embed"].abs().max()) <= \
        np.sqrt(6.0 / (64 + 32)) * 0.02 * np.sqrt(3.0)
    assert torch.equal(a["blocks"]["attn_norm"], torch.ones(2, 32))


def test_resolve_attention_impl(monkeypatch):
    monkeypatch.delenv("ZOO_LLAMA_ATTN_IMPL", raising=False)
    assert tl.resolve_attention_impl("auto", 4096, "cpu") == "dense"
    assert tl.resolve_attention_impl("flash", 8, "cpu") == "flash"
    monkeypatch.setenv("ZOO_LLAMA_ATTN_IMPL", "dense")
    assert tl.resolve_attention_impl("auto", 4096, "cuda") == "dense"


@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_resolve_attention_impl_auto_picks_kernel_on_any_cuda_device(
        monkeypatch, device):
    # decided by the device type alone (no card needed): off Hopper the
    # kernel then raises instead of the plain version running on the card
    monkeypatch.delenv("ZOO_LLAMA_ATTN_IMPL", raising=False)
    monkeypatch.delenv("ZOO_LLAMA_FLASH_MIN_SEQ", raising=False)
    assert tl.resolve_attention_impl("auto", 512, device) == "flash"
    assert tl.resolve_attention_impl("auto", 511, device) == "dense"
