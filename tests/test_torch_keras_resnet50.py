"""The committed full-depth Keras ResNet-50 topology
(``tests/fixtures/keras/resnet50_narrow_k1_tf.h5``: Keras applications'
``ResNet50`` as a Keras 1 functional model, 'tf' ordering, 224x224x3,
filters narrowed 16x, seeded Glorot weights) imported by the port and by
the JAX package, on the CPU.

- the graph: 176 vertices (53 convolutions, 53 BatchNormalizations, 49
  ReLU activations, 16 sum merges, the stem's padding and max-pool, the
  average pool, the Flatten and the Dense head), the same configuration
  JSON and the same topological order in both packages;
- parameters and BatchNormalization moments bitwise equal (both copy the
  file's float32 arrays unchanged);
- ``output()`` on two seeded images within 1e-5 of its max abs, and the
  log-probabilities within 1e-5 abs (f32; the frameworks sum the
  convolutions in another order);
- the file stays under 2 MB.
"""

from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.modelimport import keras as jk
from deeplearning4j_tpu_torch.modelimport import keras as pk
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer)
from tests.test_torch_keras_import import _assert_bitwise

PATH = Path(__file__).resolve().parent / "fixtures" / "keras" / \
    "resnet50_narrow_k1_tf.h5"
TOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    return (pk.import_keras_model_and_weights(str(PATH), device="cpu"),
            jk.import_keras_model_and_weights(str(PATH)))


def test_topology_is_resnet50_at_full_depth(nets):
    pnet, jnet = nets
    conf = pnet.conf
    assert len(conf.vertices) == len(jnet.conf.vertices) == 176
    assert conf.topological_order == jnet.conf.topological_order
    assert conf.to_json() == jnet.conf.to_json()
    kinds = {}
    for name in conf.topological_order:
        v = conf.vertices[name]
        layer = getattr(v, "layer", None)
        kind = type(layer if layer is not None else v).__name__
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds[ConvolutionLayer.__name__] == 53
    assert kinds[BatchNormalization.__name__] == 53
    assert kinds[ActivationLayer.__name__] == 49
    assert kinds[ElementWiseVertex.__name__] == 16
    assert conf.topological_order[:4] == ["zeropadding2d_1", "conv1",
                                          "bn_conv1", "activation_1"]
    assert conf.topological_order[-1] == "fc1000"
    assert PATH.stat().st_size < 2 << 20


def test_weights_and_output_match_the_reference(nets):
    pnet, jnet = nets
    _assert_bitwise(pnet, jnet)
    assert pnet.num_params() == jnet.num_params()
    x = np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32)
    got = np.asarray(pnet.output(x), np.float64)
    want = np.asarray(jnet.output(x), np.float64)
    assert got.shape == want.shape == (2, 1000)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert np.abs(np.log(got) - np.log(want)).max() <= TOL
