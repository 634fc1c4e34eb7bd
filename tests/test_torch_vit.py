"""The port's ViT against the JAX package's, on the CPU.

Both sides start from one parameter tree (the JAX model's, carried over
by ``params_from_numpy``) and see the same numpy-seeded images. Compared,
with the tolerances and their reasons:

- the probabilities at ``tools/cross_backend_parity.py``'s shape (8x8x1
  images, patch 2, d 32, 2 heads, 1 layer), within 1e-6 abs (f32
  probabilities near 0.1; the frameworks sum in another order), and a
  3-channel copy (patch vectors in (P, P, C) order);
- one AdamW step at the 1-channel shape (``tests/test_torch_moe.py``'s bars: the loss 1e-5 abs,
  the gradients 1e-5 of each leaf's max abs, the parameters 1e-5 abs
  except near-zero-gradient elements, which may move by
  ``2·lr·(1.01 + wd·|p|)``);
- ``_patchify`` alone on a 3-channel input (C != P), bitwise: reshapes
  only;
- ``fit(DigitsDataSetIterator)`` over 3 batches of the committed real
  digits: each step's loss within 5e-4 abs of the reference's (steps 2
  and 3 start from parameters that may differ by the AdamW bound above),
  and the probabilities after it within 5e-4 abs;
- the port alone: int and one-hot labels give the same loss bits; remat
  gives the same loss bits as no remat over 2 steps (the recomputed
  forward runs the same ops); the decay mask exempts the LayerNorms, the
  biases and ``wpe`` and nothing else; bf16 compute trains finite.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.fetchers import \
    DigitsDataSetIterator as JaxDigits
from deeplearning4j_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxConfig
from deeplearning4j_tpu_torch.datasets.fetchers import DigitsDataSetIterator
from deeplearning4j_tpu_torch.models.transformer import params_from_numpy
from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
from tests.test_torch_moe import _flat, _np_tree, assert_one_step_matches

# tools/cross_backend_parity.py's ViT shape
PARITY = dict(image_size=8, n_channels=1, patch_size=2, n_classes=10,
              d_model=32, n_heads=2, n_layers=1, d_ff=64, seed=0)
# tests/test_vit.py's shape, trained on the digits
DIGITS = dict(image_size=8, n_channels=1, patch_size=2, n_classes=10,
              d_model=64, n_heads=4, n_layers=2, d_ff=128,
              learning_rate=1e-3, seed=0)


def _images(seed, n=4, c=1):
    return np.random.RandomState(seed).rand(n, 8, 8, c).astype(np.float32)


def _pair(**kw):
    jv = JaxViT(JaxConfig(**kw)).init()
    pv = ViT(ViTConfig(**kw), device="cpu")
    pv.params = params_from_numpy(_np_tree(jv.params), "cpu")
    return jv, pv


def _digits(n=32):
    ds = next(DigitsDataSetIterator(n, train=True))
    return ds.features, ds.labels.argmax(1)


@pytest.mark.parametrize("channels", [1, 3])
def test_probabilities_and_one_step_match_the_reference(channels):
    jv, pv = _pair(**dict(PARITY, n_channels=channels))
    x = _images(1, c=channels)
    want = np.asarray(jv.output(x))
    got = pv.output(x)
    assert got.shape == want.shape == (4, 10)
    assert np.abs(got - want).max() <= 1e-6
    if channels != 1:
        return          # the step's program is the 1-channel one's
    y = np.random.RandomState(2).randint(0, 10, 4)
    want_loss = float(jv.fit_batch(x, y))
    got_loss = float(pv.fit_batch(x, y))
    c = pv.conf
    assert_one_step_matches(pv.params, pv.opt_state["m"], got_loss,
                            _np_tree(jv.params), _np_tree(jv.opt_state["m"]),
                            want_loss, c.learning_rate, c.weight_decay)
    assert pv.iteration == int(jv.iteration) == 1


def test_patchify_is_the_reference_s():
    kw = dict(PARITY, n_channels=3, patch_size=4)
    x = np.random.RandomState(3).rand(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(JaxViT(JaxConfig(**kw))._patchify(x))
    got = ViT(ViTConfig(**kw), device="cpu")._patchify(torch.from_numpy(x))
    assert got.shape == (2, 4, 48)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fit_over_digits_matches_the_reference():
    jv, pv = _pair(**DIGITS)
    scores = {"jax": [], "port": []}

    class Listener:
        def __init__(self, key):
            self.key = key

        def iteration_done(self, model, iteration):
            scores[self.key].append(float(model.score_))
    jv.set_listeners(Listener("jax"))
    pv.set_listeners(Listener("port"))
    jv.fit(JaxDigits(64, train=True, num_examples=192))
    pv.fit(DigitsDataSetIterator(64, train=True, num_examples=192))
    assert len(scores["port"]) == 3 and pv.iteration == 3
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=0,
                               atol=5e-4)
    x, _ = _digits(32)
    assert np.abs(pv.output(x) - np.asarray(jv.output(x))).max() <= 5e-4
    assert pv.predict(x).shape == (32,)
    assert 0.0 <= pv.evaluate(x, _digits(32)[1]) <= 1.0


def test_int_and_onehot_labels_give_the_same_step():
    x, y = _digits()
    a = ViT(ViTConfig(**DIGITS), device="cpu").init()
    b = ViT(ViTConfig(**DIGITS), device="cpu").init()
    la = a.fit_batch(x, y)
    lb = b.fit_batch(x, np.eye(10, dtype=np.float32)[y])
    assert float(la) == float(lb)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_is_bit_equivalent(dropout):
    x, y = _digits()
    a = ViT(ViTConfig(**dict(DIGITS, dropout=dropout)), device="cpu").init()
    b = ViT(ViTConfig(**dict(DIGITS, dropout=dropout, remat=True)),
            device="cpu").init()
    for _ in range(2):
        la = a.fit_batch(x, y)
        lb = b.fit_batch(x, y)
    assert float(la) == float(lb)


def test_decay_exempts_norms_biases_and_wpe():
    x, y = _digits()
    a = ViT(ViTConfig(**dict(DIGITS, weight_decay=0.5, learning_rate=0.1)),
            device="cpu").init()
    b = ViT(ViTConfig(**dict(DIGITS, weight_decay=0.0, learning_rate=0.1)),
            device="cpu").init()
    a.fit_batch(x, y)
    b.fit_batch(x, y)
    fa, fb = _flat(a.params), _flat(b.params)
    for path, pa in fa.items():
        name = path.split(".")[-1]
        exempt = pa.ndim < 2 or name == "wpe"
        assert np.array_equal(pa, fb[path]) == exempt, path


def test_bf16_trains_finite():
    x, y = _digits()
    vit = ViT(ViTConfig(**dict(DIGITS, compute_dtype="bfloat16")),
              device="cpu").init()
    losses = [float(vit.fit_batch(x, y)) for _ in range(3)]
    assert all(np.isfinite(losses))
    assert vit.output(x[:4]).shape == (4, 10)


def test_init_has_the_reference_tree_and_rejects_bad_configs():
    jv = JaxViT(JaxConfig(**DIGITS)).init()
    pv = ViT(ViTConfig(**DIGITS), device="cpu").init()
    got = {k: v.shape for k, v in _flat(pv.params).items()}
    want = {k: v.shape for k, v in _flat(jax.tree.map(np.asarray,
                                                      jv.params)).items()}
    assert got == want
    assert pv.num_params() == jv.num_params()
    with pytest.raises(ValueError, match="patch_size"):
        ViTConfig(**dict(DIGITS, patch_size=3))
    with pytest.raises(ValueError, match="divisible"):
        ViTConfig(**dict(DIGITS, d_model=30))
