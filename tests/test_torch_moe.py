"""The port's MoE feed-forward and MoELlama against ``zoo_tpu``'s.

The same numpy inputs and the JAX package's weights (carried over by
``params_from_jax``) go through ``zoo_tpu.ops.moe.moe_ffn`` and the
port's, and through both ``MoELlama``s.

Tolerances: f32 outputs, aux losses and gradients within 1e-6 absolute
(sums of at most 32 terms, taken in another order). Under bf16 inputs
each is within 4 bf16 ulps of the reference's largest magnitude
(2^-6 * max|ref|): the routing (top-k, capacity, the one-hot dispatch)
is exact in both, but XLA keeps f32 across a fused elementwise chain
(silu times the up product) where eager PyTorch rounds each op to bf16,
so products differ by 1-2 ulps (measured at most 2.2). MoELlama's f32
logits within 1e-5 (two blocks of such sums); its SGD losses within
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import knobs as jax_knobs
from zoo_tpu.models.llm import MoELlama as JaxMoELlama
from zoo_tpu.models.llm import tiny_llama_config as jax_tiny
from zoo_tpu.ops import moe as jax_moe

from zoo_tpu_torch.common import knobs as port_knobs
from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm import (
    MoELlama,
    place_moe_params,
    tiny_llama_config,
)
from zoo_tpu_torch.ops import moe

jax.config.update("jax_platforms", "cpu")

H, F, E = 16, 32, 4


@pytest.fixture(scope="module")
def moe_params():
    p = jax_moe.init_moe_params(jax.random.PRNGKey(0), H, F, E)
    return p, {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("n_tokens", [1, 8, 64, 512, 1000])
@pytest.mark.parametrize("n_experts,top_k", [(2, 1), (4, 2), (8, 2)])
@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0])
def test_expert_capacity_matches_jax(n_tokens, n_experts, top_k, factor):
    assert moe.expert_capacity(n_tokens, n_experts, top_k, factor) == \
        jax_moe.expert_capacity(n_tokens, n_experts, top_k, factor)


def _inputs(seed, dtype):
    """(2, 13, H): 26 tokens in groups of 16 (the last one padded), row
    (0, 3) zero so its router probabilities tie across every expert."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 13, H).astype(np.float32)
    x[0, 3] = 0.0
    ct = rs.randn(2, 13, H).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, np.asarray(jx.astype(jnp.float32)), ct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_moe_ffn_output_aux_and_grads_match_jax(moe_params, dtype, top_k,
                                                factor):
    jp, npp = moe_params
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, x32, ct = _inputs(top_k + int(factor * 4), jdt)

    def jloss(p, x):
        y, a = jax_moe.moe_ffn(p, x, top_k=top_k, capacity_factor=factor,
                               group_size=16)
        return jnp.sum(y.astype(jnp.float32) * ct) + 3.0 * a, (y, a)

    (_, (jy, ja)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jx)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in npp.items()}
    tx = torch.tensor(x32).to(tdt).requires_grad_(True)
    ty, ta = moe.moe_ffn(tp, tx, top_k=top_k, capacity_factor=factor,
                         group_size=16)
    assert ty.dtype == tdt and ta.dtype == torch.float32 and ta.dim() == 0
    ((ty.float() * torch.from_numpy(ct)).sum() + 3.0 * ta).backward()

    def close(got, want, what):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        got = got.detach().float().numpy()
        tol = 1e-6 if dtype == "float32" else \
            2.0 ** -6 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=what)

    close(ty, jy, "y")
    close(ta, ja, "aux")
    close(tx.grad, jgx, "dx")
    for k in npp:
        close(tp[k].grad, jgp[k], "d" + k)
    if factor == 0.25:
        # the tightest capacity: some tokens are dropped (zero rows)
        rows = np.abs(ty.detach().float().numpy()).reshape(-1, H).sum(-1)
        assert (rows == 0).sum() > 0


def test_a_tied_row_takes_the_lower_experts_first():
    """Equal probabilities: the stable descending sort keeps JAX's
    top_k order, the lower index first."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    vals, idx = moe._top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[0, 1], [1, 3]]


def test_one_hot_past_capacity_is_a_zero_row():
    got = moe._one_hot(torch.tensor([0, 2, 3, 7]), 3)
    want = jax.nn.one_hot(jnp.asarray([0, 2, 3, 7]), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_capacity_factor_reads_the_knob(moe_params, monkeypatch):
    _, npp = moe_params
    tp = {k: torch.tensor(v) for k, v in npp.items()}
    x = torch.from_numpy(np.ones((4, 16, H), np.float32))
    monkeypatch.setenv("ZOO_MOE_CAPACITY", "0.25")
    knob, _ = moe.moe_ffn(tp, x, top_k=1)
    explicit, _ = moe.moe_ffn(tp, x, top_k=1, capacity_factor=0.25)
    assert torch.equal(knob, explicit)
    wide, _ = moe.moe_ffn(tp, x, top_k=1, capacity_factor=4.0)
    assert not torch.equal(knob, wide)


def test_the_knob_copy_is_the_jax_registrys():
    mine, ref = port_knobs.get("ZOO_MOE_CAPACITY"), \
        jax_knobs.get("ZOO_MOE_CAPACITY")
    assert (mine.type, mine.default) == (ref.type, ref.default) == \
        ("float", 1.25)
    assert port_knobs.value("ZOO_MOE_CAPACITY", {}) == 1.25


def test_mesh_placement_raises_naming_a14():
    with pytest.raises(NotImplementedError, match="ROADMAP A.14"):
        place_moe_params({}, None)
    with pytest.raises(NotImplementedError, match="ROADMAP A.14"):
        moe.moe_param_specs(4)


def test_init_uses_jax_fans_for_the_expert_banks():
    """JAX's glorot on an (E, H, F) bank counts E in the receptive
    field: the bound is sqrt(6 / (E (H + F))), not sqrt(6 / (H + F))."""
    cfg = tiny_llama_config(vocab=64)
    m = MoELlama.from_seed(cfg, seed=1, device="cpu", n_experts=E)
    blocks = m.params["blocks"]
    assert set(blocks) == set(MoELlama.block_keys)
    h, f = cfg.hidden, cfg.intermediate
    for k, (a, b) in (("w_gate", (h, f)), ("w_up", (h, f)),
                      ("w_down", (f, h))):
        assert blocks[k].shape == (cfg.n_block, E, a, b)
        lim = np.sqrt(6.0 / (E * (a + b)))
        top = float(blocks[k].detach().abs().max())
        assert 0.9 * lim < top <= lim, k
    assert blocks["router"].shape == (cfg.n_block, h, E)
    assert float(blocks["router"].detach().abs().max()) <= \
        np.sqrt(6.0 / (h + E))
    banks = moe.init_moe_params(torch.Generator().manual_seed(0), H, F, E)
    assert float(banks["w_gate"].abs().max()) <= np.sqrt(6.0 / (E * (H + F)))
    jbanks = jax_moe.init_moe_params(jax.random.PRNGKey(0), H, F, E)
    assert {k: v.shape for k, v in banks.items()} == \
        {k: tuple(v.shape) for k, v in jbanks.items()}


@pytest.fixture(scope="module")
def jax_moe_llama():
    cfg = jax_tiny(vocab=64)
    jm = JaxMoELlama(cfg, n_experts=E, top_k=2)
    params = jm.build(jax.random.PRNGKey(0), (None, 8))
    return cfg, jm, params, jax.tree_util.tree_map(np.asarray, params)


def _port_moe(tree, remat=False):
    return MoELlama(tiny_llama_config(vocab=64),
                    params_from_jax(tree, "cpu"), n_experts=E, top_k=2,
                    attention_impl="dense", remat=remat)


def test_params_from_jax_carries_an_moe_tree_whole(jax_moe_llama):
    _, _, _, tree = jax_moe_llama
    got = params_from_jax(tree, "cpu")
    assert set(got["blocks"]) == set(tree["blocks"]) == \
        set(MoELlama.block_keys)
    for k, v in tree["blocks"].items():
        np.testing.assert_array_equal(got["blocks"][k].numpy(), v)
    bad = dict(tree, blocks=dict(tree["blocks"], w_extra=np.zeros(1)))
    with pytest.raises(ValueError, match="w_extra"):
        params_from_jax(bad, "cpu")
    with pytest.raises(ValueError, match="lm_extra"):
        params_from_jax(dict(tree, lm_extra=np.zeros(1)), "cpu")


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_call_and_call_with_aux_match_jax(jax_moe_llama, remat):
    cfg, _, params, tree = jax_moe_llama
    jm = JaxMoELlama(cfg, n_experts=E, top_k=2, remat=remat,
                     attention_impl="dense")
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 64, (3, 8)).astype(np.int32)
    labels = np.roll(ids, -1, 1)

    def jloss(p):
        logits, aux = jm.call_with_aux(p, jnp.asarray(ids))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        nll = -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))
        return nll + aux, (logits, aux)

    (_, (jlogits, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
        params)
    jcall = np.asarray(jm.call(params, jnp.asarray(ids)))

    m = _port_moe(tree, remat)
    with torch.no_grad():
        out = m(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), jcall, atol=1e-5)
    logits, aux = m.call_with_aux(m.params, torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-6)
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, torch.from_numpy(labels).long()[..., None]).mean()
    (nll + aux).backward()
    for k in MoELlama.block_keys:
        np.testing.assert_allclose(m.blocks[k].grad.numpy(),
                                   np.asarray(jg["blocks"][k]), atol=1e-5,
                                   err_msg=k)
    assert float(m.blocks["router"].grad.abs().max()) > 0


def test_sgd_steps_match_the_jax_loop(jax_moe_llama):
    """The JAX package's MoE train-step test (loss = CE + aux, p -= 0.05
    g), six steps, without its mesh."""
    cfg, _, params, tree = jax_moe_llama
    jm = JaxMoELlama(cfg, n_experts=E, top_k=2)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 64, (16, 8)).astype(np.int32)
    labels = np.roll(ids, -1, 1)

    def jloss(p):
        logits, aux = jm.call_with_aux(p, jnp.asarray(ids))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[..., None],
                                             -1)) + aux

    @jax.jit
    def jstep(p):
        loss, g = jax.value_and_grad(jloss)(p)
        return loss, jax.tree_util.tree_map(lambda w, gr: w - 0.05 * gr,
                                            p, g)

    m = _port_moe(tree)
    ref, got = [], []
    p = params
    lab = torch.from_numpy(labels).long()[..., None]
    for _ in range(6):
        loss, p = jstep(p)
        ref.append(float(loss))
        logits, aux = m.call_with_aux(m.params, torch.from_numpy(ids))
        logp = torch.log_softmax(logits.float(), -1)
        t_loss = -logp.gather(-1, lab).mean() + aux
        grads = torch.autograd.grad(t_loss, list(m.parameters()))
        with torch.no_grad():
            for w, g in zip(m.parameters(), grads):
                w -= 0.05 * g
        got.append(float(t_loss))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert got[-1] < got[0]


def test_dots_remat_recomputes_the_expert_products_and_keeps_the_mms():
    """``remat="dots"`` keeps ``mm`` outputs (the router's, the
    attention half's projections) and recomputes the batched products:
    each block's dispatch, three expert products and combine (5 ``bmm``)
    run again in the backward, as JAX's
    ``dots_with_no_batch_dims_saveable`` recomputes them; ``True``
    recomputes the whole block (its 5 ``mm`` and the dense attention's 2
    ``bmm`` too)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"bmm": 0, "mm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for k, op in (("bmm", torch.ops.aten.bmm.default),
                          ("mm", torch.ops.aten.mm.default)):
                self.n[k] += func is op
            return func(*args, **(kwargs or {}))

    cfg = tiny_llama_config(vocab=64)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 16)))
    counts = {}
    for remat in (False, "dots", True):
        m = MoELlama.from_seed(cfg, seed=0, device="cpu", n_experts=E,
                               remat=remat, attention_impl="dense")
        with Count() as c:
            m(ids).float().sum().backward()
        counts[remat] = c.n
    L = cfg.n_block
    assert counts["dots"]["bmm"] - counts[False]["bmm"] == 5 * L
    assert counts["dots"]["mm"] == counts[False]["mm"]
    assert counts[True]["bmm"] - counts[False]["bmm"] == 7 * L
    assert counts[True]["mm"] - counts[False]["mm"] == 5 * L


def test_a_sequential_moe_llama_round_trips_a_model_file(tmp_path):
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet
    m = Sequential().add(MoELlama(tiny_llama_config(vocab=64), n_experts=E,
                                  top_k=1, capacity_factor=2.0,
                                  input_shape=(8,)))
    m.build(device="cpu")
    ids = np.random.RandomState(3).randint(0, 64, (2, 8)).astype(np.int32)
    path = str(tmp_path / "moe.model")
    m.save(path)
    back = KerasNet.load(path, device="cpu")
    layer = back.layers[0]
    assert (type(layer), layer.n_experts, layer.top_k,
            layer.capacity_factor) == (MoELlama, E, 1, 2.0)
    np.testing.assert_array_equal(back.predict(ids, device="cpu"),
                                  m.predict(ids, device="cpu"))
