"""Model zoo configurations: the port of ``deeplearning4j_tpu/models/zoo.py``
for the builders this package can build (LeNet, the MLP and the
char-RNN). The builders are the reference's, call for call, so each gives
the same ``MultiLayerConfiguration`` JSON as its counterpart there. The
ComputationGraph zoo (ResNet-50, VGG-16, AlexNet, GoogLeNet) waits for
ComputationGraph (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                DenseLayer, GravesLSTM,
                                                OutputLayer, RnnOutputLayer,
                                                SubsamplingLayer)

__all__ = ["char_rnn", "lenet_mnist", "mlp_mnist"]


def lenet_mnist(seed=12345, learning_rate=0.01, updater="nesterovs"):
    """LeNet for 28x28x1 MNIST (LenetMnistExample): conv 5x5x20, max-pool
    2, conv 5x5x50, max-pool 2, dense 500, softmax 10; Nesterov momentum
    0.9."""
    return (NeuralNetConfiguration.Builder()
            .seed(seed)
            .learning_rate(learning_rate)
            .updater(updater)
            .momentum(0.9)
            .weight_init("xavier")
            .activation("identity")
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())


def mlp_mnist(seed=12345, hidden=1000, learning_rate=0.006):
    """Single-hidden-layer MNIST MLP (MLPMnistSingleLayerExample)."""
    return (NeuralNetConfiguration.Builder()
            .seed(seed)
            .learning_rate(learning_rate)
            .updater("nesterovs").momentum(0.9)
            .regularization(True).l2(1e-4)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_in=784, n_out=hidden, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .build())


def char_rnn(vocab_size=77, hidden=200, t_length=None, seed=12345,
             learning_rate=0.1, tbptt_length=50):
    """GravesLSTM character RNN (GravesLSTMCharModellingExample): two
    peephole LSTMs and a softmax RnnOutputLayer, rmsprop, tBPTT."""
    return (NeuralNetConfiguration.Builder()
            .seed(seed)
            .learning_rate(learning_rate)
            .updater("rmsprop").rms_decay(0.95)
            .weight_init("xavier")
            .list()
            .layer(GravesLSTM(n_in=vocab_size, n_out=hidden, activation="tanh"))
            .layer(GravesLSTM(n_in=hidden, n_out=hidden, activation="tanh"))
            .layer(RnnOutputLayer(n_in=hidden, n_out=vocab_size,
                                  activation="softmax", loss="mcxent"))
            .backprop_type("tbptt")
            .tbptt_fwd_length(tbptt_length).tbptt_back_length(tbptt_length)
            .set_input_type(InputType.recurrent(vocab_size, t_length))
            .build())
