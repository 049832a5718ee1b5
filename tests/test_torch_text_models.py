"""The port's CRF and the tagging models on it against ``zoo_tpu``'s.

The CRF negative log-likelihood and Viterbi decode are held against the
JAX functions and against brute force over every tag sequence. ``NER``,
``SequenceTagger`` and ``IntentEntity`` get the JAX model's weights
(``keras_params_from_jax``) and its layer names (dropout keys are
``fold_in(rng, crc32(name))``, so a ``fit`` draws JAX's masks only
under the same names).

Tolerances: the NLL within 1e-5 relative of JAX's and of brute force
(f32 logsumexp chains over at most 6 steps); decoded paths exact (no
near-ties in these draws: the best and second-best path scores are
held at least 1e-3 apart first); model outputs within 1e-5 absolute;
``fit`` per-epoch losses within rtol 1e-4 and every parameter within
1e-4 absolute, as the other f32 fit tests hold them. Model files
round-trip bit-equal.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models import text as jtext

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models import text
from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet

jax.config.update("jax_platforms", "cpu")

T, W, E = 6, 4, 5
SIZES = dict(word_vocab_size=20, char_vocab_size=10, sequence_length=T,
             word_length=W)


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _packed(seed, b=3, t=T, e=E):
    rs = np.random.RandomState(seed)
    em = rs.randn(b, t, e).astype(np.float32)
    tr = rs.randn(e, e).astype(np.float32)
    return np.concatenate([em, np.broadcast_to(tr, (b, e, e))], 1), em, tr


def _brute(em, tr):
    """Every path's score: (B, E**T) and the paths."""
    paths = np.array(list(itertools.product(range(em.shape[2]),
                                            repeat=em.shape[1])))
    emis = em[:, np.arange(em.shape[1]), paths].sum(-1)
    trans = tr[paths[:, :-1], paths[:, 1:]].sum(-1)
    return emis + trans[None], paths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_nll_and_decode_match_jax_and_brute_force(seed):
    packed, em, tr = _packed(seed)
    scores, paths = _brute(em, tr)
    top2 = np.sort(scores, 1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-3).all()
    rs = np.random.RandomState(seed + 10)
    y = rs.randint(0, E, (3, T)).astype(np.int32)
    got_nll = float(text.crf_negative_log_likelihood(
        torch.from_numpy(y), torch.from_numpy(packed)))
    jax_nll = float(jtext.crf_negative_log_likelihood(jnp.asarray(y),
                                                      jnp.asarray(packed)))
    idx = [int(np.flatnonzero((paths == y[b]).all(1))[0]) for b in range(3)]
    lse = np.log(np.exp(scores.astype(np.float64)).sum(1))
    brute_nll = float(np.mean(lse - scores[np.arange(3), idx]))
    np.testing.assert_allclose(got_nll, jax_nll, rtol=1e-5)
    np.testing.assert_allclose(got_nll, brute_nll, rtol=1e-5)
    # (B, T, 1) labels read the same
    assert float(text.crf_negative_log_likelihood(
        torch.from_numpy(y[..., None]), torch.from_numpy(packed))) == got_nll
    got = text.crf_decode(torch.from_numpy(packed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtext.crf_decode(packed)))
    np.testing.assert_array_equal(got.numpy(), paths[scores.argmax(1)])


def test_crf_nll_gradient_matches_jax():
    packed, _, _ = _packed(4)
    y = np.random.RandomState(4).randint(0, E, (3, T)).astype(np.int32)
    want = np.asarray(jax.grad(lambda p: jtext.crf_negative_log_likelihood(
        jnp.asarray(y), p))(jnp.asarray(packed)))
    p = torch.from_numpy(packed).requires_grad_(True)
    text.crf_negative_log_likelihood(torch.from_numpy(y), p).backward()
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-6)


def test_decode_breaks_ties_toward_the_lower_tag():
    packed = np.zeros((1, 3 + 2, 2), np.float32)   # every path ties
    assert text.crf_decode(torch.from_numpy(packed)).tolist() == [[0, 0, 0]]
    np.testing.assert_array_equal(np.asarray(jtext.crf_decode(packed)),
                                  [[0, 0, 0]])


def _inputs(n, seed=0):
    rs = np.random.RandomState(seed)
    words = rs.randint(0, 20, (n, T)).astype(np.int32)
    chars = rs.randint(0, 10, (n, T, W)).astype(np.int32)
    return words, chars


def _pair(jm, tm):
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(0)))
    tm.params = keras_params_from_jax(tree, "cpu")
    assert [type(a).__name__ for a in jm.layers] == \
        [type(b).__name__ for b in tm.layers]
    for a, b in zip(jm.layers, tm.layers):
        b.name = a.name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(getattr(v, "detach", lambda: v)())
    return out


def _models(kind, classifier):
    if kind == "ner":
        kw = dict(SIZES, word_emb_dim=6, char_emb_dim=4, tagger_lstm_dim=5,
                  dropout=0.3, classifier=classifier)
        return jtext.NER(E, **kw), text.NER(E, **kw)
    if kind == "tagger":
        kw = dict(SIZES, feature_size=6, dropout=0.2, classifier=classifier)
        return (jtext.SequenceTagger(4, E, **kw),
                text.SequenceTagger(4, E, **kw))
    kw = dict(SIZES, word_emb_dim=6, char_emb_dim=4, char_lstm_dim=3,
              tagger_lstm_dim=5, classifier=classifier)
    return jtext.IntentEntity(3, E, **kw), text.IntentEntity(3, E, **kw)


def _labels(kind, n, seed=1):
    rs = np.random.RandomState(seed)
    tags = rs.randint(0, E, (n, T)).astype(np.int32)
    if kind == "ner":
        return tags
    if kind == "tagger":
        return [rs.randint(0, 4, (n, T)).astype(np.int32), tags]
    return [rs.randint(0, 3, n).astype(np.int32), tags]


@pytest.mark.parametrize("kind,classifier", [
    ("ner", "crf"), ("ner", "softmax"), ("tagger", "crf"),
    ("tagger", "softmax"), ("intent", "crf"), ("intent", "softmax")])
def test_forward_matches_jax(kind, classifier):
    jm, tm = _models(kind, classifier)
    _pair(jm, tm)
    x = list(_inputs(4))
    want = jm.predict(x)
    got = tm.predict(x, device="cpu")
    for a, b in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, (list, tuple)) else [want]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    if kind == "ner":
        np.testing.assert_array_equal(
            tm.predict_tags(*x, device="cpu"), jm.predict_tags(*x))


@pytest.mark.parametrize("kind", ["ner", "tagger", "intent"])
def test_fit_matches_jax(kind):
    jm, tm = _models(kind, "crf")
    for m in (jm, tm):
        m.compile(optimizer="adam", loss=m.default_loss())
    _pair(jm, tm)
    x, y = list(_inputs(8, seed=2)), _labels(kind, 8)
    want = jm.fit(x, y, batch_size=4, nb_epoch=2, shuffle=True, seed=1,
                  verbose=0)
    got = tm.fit(x, y, batch_size=4, nb_epoch=2, shuffle=True, seed=1,
                 verbose=0, device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    have = _flat(tm.params)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray,
                                             jm.params)).items():
        np.testing.assert_allclose(have[k], v, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind", ["ner", "tagger", "intent"])
def test_model_files_round_trip(kind, tmp_path):
    _, tm = _models(kind, "crf")
    tm.compile(optimizer="adam", loss=tm.default_loss())
    tm.build(device="cpu")
    x = list(_inputs(3))
    path = str(tmp_path / f"{kind}.model")
    tm.save(path)
    back = type(tm).load_model(path, device="cpu")
    assert type(back) is type(tm)
    a, b = back.predict(x, device="cpu"), tm.predict(x, device="cpu")
    for u, v in zip(a if isinstance(a, tuple) else [a],
                    b if isinstance(b, tuple) else [b]):
        np.testing.assert_array_equal(u, v)


def test_pad_mode_and_unknown_heads_are_refused():
    with pytest.raises(ValueError, match="pad"):
        text.NER(E, crf_mode="pad", **SIZES)
    with pytest.raises(ValueError, match="classifier"):
        text.NER(E, classifier="svm", **SIZES)
    with pytest.raises(ValueError, match="classifier"):
        text.SequenceTagger(4, E, 20, classifier="svm")
    with pytest.raises(ValueError, match="classifier"):
        text.IntentEntity(3, E, 20, 10, classifier="svm")
