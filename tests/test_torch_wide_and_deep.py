"""The port's Wide & Deep against ``zoo_tpu``'s: all three
``model_type``s, the same weights (``keras_params_from_jax``) and the
same numpy rows (ids and a continuous column in one f32 matrix, as the
JAX package's test feeds them).

Tolerances: probabilities within 1e-6 absolute (f32 sums of at most 40
terms, in another order); a 2-epoch ``fit``: per-epoch losses within
rtol 1e-4, and with SGD every parameter within 1e-5 absolute. With
Adam (the reference notebook's optimizer) only the losses are held: a
wide table starts at zero, so where a row's samples cover the classes
evenly its first gradient cancels to a rounding residue, whose sign
differs between the two frameworks, and Adam's normalised step turns
either sign into a step of about lr. The model file round-trips
bit-equal.
"""

import jax
import numpy as np
import pytest

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.recommendation import ColumnFeatureInfo as JColumns
from zoo_tpu.models.recommendation import WideAndDeep as JWideAndDeep

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.recommendation import (
    ColumnFeatureInfo,
    WideAndDeep,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet

jax.config.update("jax_platforms", "cpu")

COLUMNS = dict(
    wide_base_cols=["occupation", "gender"], wide_base_dims=[5, 2],
    wide_cross_cols=["age_gender"], wide_cross_dims=[12],
    indicator_cols=["genres", "gender"], indicator_dims=[4, 2],
    embed_cols=["user", "item"], embed_in_dims=[20, 30],
    embed_out_dims=[4, 6], continuous_cols=["age"])


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _rows(n=48, seed=0):
    rs = np.random.RandomState(seed)
    cols = [rs.randint(0, d, n) for d in (5, 2, 12, 4, 2, 20, 30)]
    x = np.stack(cols + [rs.uniform(18, 60, n)], 1).astype(np.float32)
    y = rs.randint(0, 3, n).astype(np.int32)
    return x, y


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(getattr(v, "detach", lambda: v)())
    return out


def _pair(model_type):
    jm = JWideAndDeep(3, JColumns(**COLUMNS), model_type=model_type,
                      hidden_layers=(8, 4))
    tm = WideAndDeep(3, ColumnFeatureInfo(**COLUMNS), model_type=model_type,
                     hidden_layers=(8, 4))
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(0)))
    tm.params = keras_params_from_jax(tree, "cpu")
    assert [type(a).__name__ for a in jm.layers] == \
        [type(b).__name__ for b in tm.layers]
    assert sorted(tm.params) == sorted(tree)
    return jm, tm


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("model_type", ["wide_n_deep", "wide", "deep"])
def test_forward_and_fit_match_jax(model_type, optimizer):
    x, y = _rows()
    jm, tm = _pair(model_type)
    np.testing.assert_allclose(tm.predict(x, device="cpu"),
                               np.asarray(jm.predict(x)), atol=1e-6)
    for m in (jm, tm):
        m.compile(optimizer=optimizer,
                  loss="sparse_categorical_crossentropy")
    want = jm.fit(x, y, batch_size=8, nb_epoch=2, shuffle=True, seed=1,
                  verbose=0)
    got = tm.fit(x, y, batch_size=8, nb_epoch=2, shuffle=True, seed=1,
                 verbose=0, device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    if optimizer == "adam":
        return
    have = _flat(tm.params)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray,
                                             jm.params)).items():
        np.testing.assert_allclose(have[k], v, atol=1e-5, err_msg=k)


def test_indicator_tables_start_as_identity_and_wide_ones_at_zero():
    tm = WideAndDeep(7, ColumnFeatureInfo(**COLUMNS))
    tm.build(device="cpu")
    tables = [(k, p["E"]) for k, p in sorted(tm.params.items())
              if "embedding" in k]
    wide = [e for _, e in tables if e.shape[1] == 7]
    assert len(wide) == 3 and all(float(e.abs().max()) == 0 for e in wide)
    eyes = [e for _, e in tables if e.shape[0] == e.shape[1]]
    assert sorted(e.shape[0] for e in eyes) == [3, 5]
    for e in eyes:
        np.testing.assert_array_equal(e.numpy(), np.eye(e.shape[0]))


def test_model_file_round_trips(tmp_path):
    x, _ = _rows(8)
    _, tm = _pair("wide_n_deep")
    path = str(tmp_path / "wnd.model")
    tm.save(path)
    back = KerasNet.load(path, device="cpu")
    assert isinstance(back, WideAndDeep)
    assert back.column_info == tm.column_info
    np.testing.assert_array_equal(back.predict(x, device="cpu"),
                                  tm.predict(x, device="cpu"))


def test_an_unknown_model_type_is_refused():
    with pytest.raises(ValueError, match="model_type"):
        WideAndDeep(2, ColumnFeatureInfo(**COLUMNS), model_type="linear")
