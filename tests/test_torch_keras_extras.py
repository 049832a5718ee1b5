"""The rest of the port's Keras layers (``advanced``, ``extras``,
``conv_extras``, ``compat_extras`` and ``GaussianNoise``) against the
JAX package: the same seeded numpy inputs, the JAX layer's params
carried over by ``keras_params_from_jax``, the JAX layer's eager
``call`` against the port's, and ``compute_output_shape``.

Tolerances (f32): elementwise layers within 1e-6 (absolute and
relative: the two CPU backends' ``exp``, ``log``, ``pow`` and
``sigmoid`` may round differently); convs, products and reductions
within 1e-5 (sums taken in another order). Training draws: ``RReLU``'s
slopes and ``SpatialDropout3D``'s mask bit-equal (integer work), the
normal draws of ``GaussianNoise``, ``GaussianDropout`` and
``GaussianSampler`` within 4 f32 ulp of the output's largest magnitude
(``normal`` is within 3 ulp of ``jax.random.normal``,
``tests/test_torch_random.py``). The export lists of the two
``layers`` packages are equal, and ``KerasLayerWrapper`` is the one
refusal (ROADMAP A.16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.pipeline.api.keras import layers as jlayers

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.ops import random as R
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    tree_leaves,
    tree_map,
)

jax.config.update("jax_platforms", "cpu")

ELEMENTWISE, REDUCED = 1e-6, 1e-5
B = 2


def _x(shape, seed=0, low=None, high=None):
    rs = np.random.RandomState(seed)
    if low is not None:
        return rs.uniform(low, high, (B,) + shape).astype(np.float32)
    return rs.randn(*((B,) + shape)).astype(np.float32)


def _ids(shape, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B,) + shape) \
        .astype(np.int32)


# name, constructor kwargs, input shape (no batch), input, tolerance
CASES = [
    ("LeakyReLU", dict(alpha=0.2), (5, 4), None, ELEMENTWISE),
    ("ELU", dict(alpha=0.7), (5, 4), None, ELEMENTWISE),
    ("ThresholdedReLU", dict(theta=0.3), (5, 4), None, ELEMENTWISE),
    ("PReLU", {}, (5, 4), None, ELEMENTWISE),
    ("SReLU", {}, (5, 4), None, ELEMENTWISE),
    ("Highway", dict(activation="tanh"), (6,), None, REDUCED),
    ("MaxoutDense", dict(output_dim=3, nb_feature=4), (6,), None, REDUCED),
    ("Identity", {}, (3, 4), None, ELEMENTWISE),
    ("Exp", {}, (3, 4), None, ELEMENTWISE),
    ("Log", {}, (3, 4), (0.1, 5.0), ELEMENTWISE),
    ("Sqrt", {}, (3, 4), (0.1, 5.0), ELEMENTWISE),
    ("Square", {}, (3, 4), None, ELEMENTWISE),
    ("Negative", {}, (3, 4), None, ELEMENTWISE),
    ("AddConstant", dict(constant_scalar=1.5), (3, 4), None, ELEMENTWISE),
    ("MulConstant", dict(constant_scalar=-0.3), (3, 4), None, ELEMENTWISE),
    ("Power", dict(power=2.5, scale=0.5, shift=1.0), (3, 4), (0.0, 3.0),
     ELEMENTWISE),
    ("HardTanh", dict(min_value=-0.5, max_value=0.7), (3, 4), None,
     ELEMENTWISE),
    ("HardShrink", dict(value=0.4), (3, 4), None, ELEMENTWISE),
    ("SoftShrink", dict(value=0.4), (3, 4), None, ELEMENTWISE),
    ("Threshold", dict(th=0.1, v=-2.0), (3, 4), None, ELEMENTWISE),
    ("BinaryThreshold", dict(value=0.1), (3, 4), None, ELEMENTWISE),
    ("RReLU", {}, (3, 4), None, ELEMENTWISE),
    ("CAdd", dict(size=(3, 4)), (3, 4), None, ELEMENTWISE),
    ("CMul", dict(size=(1, 4)), (3, 4), None, ELEMENTWISE),
    ("Scale", dict(size=(3, 1)), (3, 4), None, ELEMENTWISE),
    ("Narrow", dict(dim=2, offset=1, length=2), (3, 4), None, ELEMENTWISE),
    ("Narrow", dict(dim=1, offset=1, length=-1), (3, 4), None,
     ELEMENTWISE),
    ("Select", dict(dim=1, index=-1), (3, 4), None, ELEMENTWISE),
    ("Squeeze", dict(dim=2), (3, 1, 4), None, ELEMENTWISE),
    ("ExpandDim", dict(dim=1), (3, 4), None, ELEMENTWISE),
    ("ExpandDim", dict(dim=-1), (3, 4), None, ELEMENTWISE),
    ("Max", dict(dim=2), (3, 4), None, ELEMENTWISE),
    ("GetShape", {}, (3, 4), None, ELEMENTWISE),
    ("Masking", dict(mask_value=0.0), (5, 3), "masked", ELEMENTWISE),
    ("GaussianDropout", dict(p=0.3), (3, 4), None, ELEMENTWISE),
    ("GaussianSampler", {}, [(3, 4), (3, 4)], None, ELEMENTWISE),
    ("GaussianNoise", dict(sigma=0.5), (3, 4), None, ELEMENTWISE),
    ("LRN2D", dict(n=3, dim_ordering="th"), (5, 4, 4), None, REDUCED),
    ("LRN2D", dict(alpha=1e-2, n=5, dim_ordering="tf"), (4, 4, 7), None,
     REDUCED),
    ("WithinChannelLRN2D", dict(size=3), (2, 6, 5), None, REDUCED),
    ("ResizeBilinear", dict(output_height=9, output_width=4), (3, 6, 7),
     None, REDUCED),
    ("ResizeBilinear", dict(output_height=5, output_width=11,
                            dim_ordering="tf"), (12, 5, 2), None, REDUCED),
    ("Convolution3D", dict(nb_filter=4, kernel_dim1=3, kernel_dim2=2,
                           kernel_dim3=3, border_mode="same",
                           subsample=(2, 1, 2)), (3, 5, 6, 7), None,
     REDUCED),
    ("Convolution3D", dict(nb_filter=3, kernel_dim1=2, kernel_dim2=2,
                           kernel_dim3=2, dim_ordering="tf",
                           activation="relu"), (4, 5, 3, 2), None, REDUCED),
    ("AtrousConvolution2D", dict(nb_filter=4, nb_row=3, nb_col=3,
                                 atrous_rate=(2, 2), border_mode="same"),
     (3, 9, 8), None, REDUCED),
    ("AtrousConvolution1D", dict(nb_filter=4, filter_length=3,
                                 atrous_rate=2, activation="tanh"),
     (11, 3), None, REDUCED),
    ("Deconvolution2D", dict(nb_filter=3, nb_row=3, nb_col=2,
                             subsample=(2, 3)), (2, 4, 5), None, REDUCED),
    ("Deconvolution2D", dict(nb_filter=2, nb_row=2, nb_col=2,
                             dim_ordering="tf"), (4, 3, 3), None, REDUCED),
    ("SeparableConvolution2D", dict(nb_filter=5, nb_row=3, nb_col=3,
                                    depth_multiplier=2, border_mode="same",
                                    subsample=(2, 2), dim_ordering="tf"),
     (7, 8, 3), None, REDUCED),
    ("ShareConvolution2D", dict(nb_filter=4, nb_row=3, nb_col=3,
                                border_mode="same"), (3, 6, 6), None,
     REDUCED),
    ("LocallyConnected1D", dict(nb_filter=4, filter_length=3,
                                subsample_length=2), (9, 3), None, REDUCED),
    ("LocallyConnected2D", dict(nb_filter=3, nb_row=2, nb_col=3,
                                subsample=(2, 1)), (4, 7, 6), None,
     REDUCED),
    ("LocallyConnected2D", dict(nb_filter=2, nb_row=3, nb_col=2,
                                dim_ordering="tf", activation="relu"),
     (6, 5, 3), None, REDUCED),
    ("ConvLSTM2D", dict(nb_filter=3, nb_kernel=3), (4, 2, 5, 5), None,
     REDUCED),
    ("ConvLSTM2D", dict(nb_filter=2, nb_kernel=3, return_sequences=True),
     (3, 2, 4, 4), None, REDUCED),
    ("WordEmbedding", "matrix", (6,), "ids", ELEMENTWISE),
    ("MaxPooling3D", dict(pool_size=(2, 2, 2)), (3, 4, 5, 6), None,
     ELEMENTWISE),
    ("MaxPooling3D", dict(pool_size=(3, 2, 3), strides=(2, 1, 2),
                          border_mode="same", dim_ordering="tf"),
     (5, 4, 7, 2), None, ELEMENTWISE),
    ("AveragePooling3D", dict(pool_size=(2, 3, 2), border_mode="same"),
     (2, 5, 5, 3), None, REDUCED),
    ("GlobalAveragePooling3D", {}, (3, 4, 5, 2), None, REDUCED),
    ("GlobalMaxPooling3D", dict(dim_ordering="tf"), (3, 4, 5, 2), None,
     ELEMENTWISE),
    ("UpSampling3D", dict(size=(2, 1, 3)), (2, 3, 2, 2), None, ELEMENTWISE),
    ("ZeroPadding3D", dict(padding=(1, 2, 0), dim_ordering="tf"),
     (2, 3, 2, 2), None, ELEMENTWISE),
    ("Cropping3D", dict(cropping=((1, 0), (0, 2), (1, 1))), (2, 4, 5, 4),
     None, ELEMENTWISE),
    ("SpatialDropout3D", dict(p=0.4), (6, 2, 3, 2), None, ELEMENTWISE),
    ("SpatialDropout3D", dict(p=0.4, dim_ordering="tf"), (2, 3, 2, 6),
     None, ELEMENTWISE),
    ("DepthwiseConvolution2D", dict(nb_row=3, nb_col=3, depth_multiplier=2,
                                    border_mode="same", subsample=(2, 2),
                                    dim_ordering="tf", bias=True),
     (7, 6, 3), None, REDUCED),
    ("DepthwiseConvolution2D", dict(nb_row=2, nb_col=3, activation="relu"),
     (4, 6, 5), None, REDUCED),
    ("SparseDense", dict(output_dim=3, backward_start=1), (5,), None,
     REDUCED),
    ("SparseEmbedding", dict(input_dim=9, output_dim=4), (5,), "ids",
     ELEMENTWISE),
    ("Mul", {}, (3, 4), None, ELEMENTWISE),
]

# layers that draw in training: bit-equal, or the normal draws
DRAWS = {"RReLU": 0, "SpatialDropout3D": 0, "GaussianDropout": 4,
         "GaussianNoise": 4, "GaussianSampler": 4}
_MATRIX = np.random.RandomState(3).randn(10, 4).astype(np.float32)


def _ctor(kwargs):
    return dict(embedding_matrix=_MATRIX) if kwargs == "matrix" else kwargs


def _input(name, shape, spec, seed=0):
    if isinstance(shape, list):
        return [_x(s, seed + i) for i, s in enumerate(shape)]
    if spec == "ids":
        return _ids(shape, 10 if name == "WordEmbedding" else 9, seed)
    if spec == "masked":
        x = _x(shape, seed)
        x[:, 1] = 0.0
        x[0, 3] = 0.0
        return x
    if spec is not None:
        return _x(shape, seed, *spec)
    return _x(shape, seed)


def _pair(name, kwargs, shape):
    jl = getattr(jlayers, name)(**_ctor(kwargs))
    tl = getattr(tlayers, name)(**_ctor(kwargs))
    tl.name = jl.name          # the draws' keys fold the layer's name in
    in_shape = [(None,) + s for s in shape] if isinstance(shape, list) \
        else (None,) + shape
    jp = jax.tree_util.tree_map(np.asarray,
                                jl.build(jax.random.PRNGKey(0), in_shape))
    return jl, tl, jp, keras_params_from_jax(jp, "cpu"), in_shape


def _j(x):
    return [jnp.asarray(a) for a in x] if isinstance(x, list) \
        else jnp.asarray(x)


def _t(x):
    return [torch.from_numpy(a) for a in x] if isinstance(x, list) \
        else torch.from_numpy(x)


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layer_equals_jax(case):
    name, kwargs, shape, spec, tol = case
    jl, tl, jp, tp, in_shape = _pair(name, kwargs, shape)
    x = _input(name, shape, spec)
    want = np.asarray(jl.call(jp, _j(x)))
    got = tl.call(tp, _t(x)).detach().numpy()
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    shape_out = tl.compute_output_shape(in_shape)
    assert tuple(shape_out) == tuple(jl.compute_output_shape(in_shape))
    assert tuple(shape_out[1:]) == want.shape[1:]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    jkeys = jax.tree_util.tree_structure(jp)
    assert jax.tree_util.tree_structure(
        tree_map(lambda t: t.numpy(), tp)) == jkeys


@pytest.mark.parametrize("name", sorted(DRAWS))
@pytest.mark.parametrize("seed", [0, 11])
def test_training_draws_equal_jax(name, seed):
    case = next(c for c in CASES if c[0] == name)
    _, kwargs, shape, spec, _ = case
    jl, tl, jp, tp, _ = _pair(name, kwargs, shape)
    x = _input(name, shape, spec, seed)
    want = np.asarray(jl.call(jp, _j(x), training=True,
                              rng=jax.random.PRNGKey(seed)))
    got = tl.call(tp, _t(x), training=True, rng=R.PRNGKey(seed)).numpy()
    ref = np.asarray(jl.call(jp, _j(x)))
    assert not np.array_equal(want, ref)        # the draw did something
    ulps = DRAWS[name]
    if ulps == 0:
        assert np.array_equal(got, want)
    else:
        tol = ulps * np.finfo(np.float32).eps * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_gaussian_layers_without_a_key():
    """No key: ``GaussianDropout`` and ``GaussianSampler`` are the
    identity and the mean, as in JAX; ``GaussianNoise`` in training
    raises (JAX fails on a None key too)."""
    x = _x((3, 4))
    assert torch.equal(tlayers.GaussianDropout(0.3).call(
        {}, torch.from_numpy(x), training=True), torch.from_numpy(x))
    m = torch.from_numpy(x)
    assert torch.equal(tlayers.GaussianSampler().call({}, [m, m]), m)
    with pytest.raises(ValueError, match="rng"):
        tlayers.GaussianNoise(0.1).call({}, m, training=True)
    assert torch.equal(tlayers.GaussianNoise(0.1).call({}, m), m)


@pytest.mark.parametrize("name,kwargs,shape", [
    ("DepthwiseConvolution2D", dict(nb_row=3, nb_col=3, depth_multiplier=2,
                                    border_mode="same", subsample=(2, 2),
                                    dim_ordering="tf"), (7, 6, 3)),
    ("SeparableConvolution2D", dict(nb_filter=4, nb_row=3, nb_col=3,
                                    border_mode="same", dim_ordering="tf"),
     (6, 6, 3)),
    ("Deconvolution2D", dict(nb_filter=3, nb_row=3, nb_col=2,
                             subsample=(2, 3)), (2, 4, 5)),
    ("Convolution3D", dict(nb_filter=2, kernel_dim1=3, kernel_dim2=3,
                           kernel_dim3=3, border_mode="same"),
     (2, 4, 4, 4)),
    ("LocallyConnected2D", dict(nb_filter=3, nb_row=2, nb_col=3),
     (2, 5, 6)),
])
def test_conv_gradients_equal_jax(name, kwargs, shape):
    """The gradients of ``sum(out * ramp)`` in every weight and in the
    input, within 1e-5: the depthwise backward is what MobileNet's
    ``fit`` takes."""
    jl, tl, jp, tp, _ = _pair(name, kwargs, shape)
    x = _x(shape)
    jy = jl.call(jp, jnp.asarray(x))
    w = np.linspace(-1, 1, jy.size, dtype=np.float32).reshape(jy.shape)
    jgp, jgx = jax.grad(lambda p, a: (jl.call(p, a) * w).sum(),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    loss = (tl.call(tree, tx) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, tree_leaves(tree) + [tx])
    want = jax.tree_util.tree_leaves(jgp) + [jgx]
    assert len(grads) == len(want)
    for g, v in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=REDUCED,
                                   rtol=REDUCED)


def test_depthwise_orders_outputs_channel_major():
    """Output ``c * multiplier + m`` reads input channel ``c``: a kernel
    that is zero but for output 3 (c = 1, m = 1) copies channel 1."""
    layer = tlayers.DepthwiseConvolution2D(1, 1, depth_multiplier=2,
                                           dim_ordering="tf", bias=False)
    w = torch.zeros((1, 1, 1, 6))
    w[..., 3] = 1.0
    x = torch.from_numpy(_x((4, 4, 3)))
    y = layer.call({"W": w}, x)
    assert torch.equal(y[..., 3], x[..., 1])
    assert float(y[..., [0, 1, 2, 4, 5]].abs().max()) == 0.0


def test_word_embedding_from_glove(tmp_path):
    from zoo_tpu.pipeline.api.keras.layers import WordEmbedding as JWE
    path = tmp_path / "glove.txt"
    path.write_text("the 0.1 0.2 0.3\ncat -1 0.5 2\ndog 3 3 3\n")
    index = {"the": 1, "cat": 2, "bird": 3}
    want = JWE.from_glove(str(path), index).matrix
    got = tlayers.WordEmbedding.from_glove(str(path), index).matrix
    assert np.array_equal(got, want)


def test_the_export_lists_are_equal():
    assert set(tlayers.__all__) == set(jlayers.__all__)
    for name in tlayers.__all__:
        assert hasattr(tlayers, name), name


def test_keras_layer_wrapper_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP A.16"):
        tlayers.KerasLayerWrapper(object(), input_shape=(3,))


def test_every_exported_layer_class_has_a_parity_case():
    """Each exported layer class of the four new modules (and
    ``GaussianNoise``) is a case of :func:`test_layer_equals_jax`."""
    from zoo_tpu_torch.pipeline.api.keras.layers import (
        advanced, compat_extras, conv_extras, extras)
    new = set()
    for mod in (advanced, compat_extras, conv_extras, extras):
        new |= {n for n in tlayers.__all__
                if getattr(tlayers, n).__module__ == mod.__name__}
    new.discard("KerasLayerWrapper")
    assert new <= {c[0] for c in CASES}
    assert "GaussianNoise" in {c[0] for c in CASES}
