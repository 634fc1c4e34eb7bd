"""Model zoo configurations: the port of ``deeplearning4j_tpu/models/zoo.py``.
The builders are the reference's, call for call, so each gives the same
configuration JSON as its counterpart there: LeNet, the MLP, the
char-RNN, VGG-16 and AlexNet (MultiLayerNetworks), and GoogLeNet and
ResNet-50 (ComputationGraphs). Activations are NHWC throughout.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.graph import (ElementWiseVertex,
                                                    MergeVertex)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, GravesLSTM, LocalResponseNormalization, OutputLayer,
    RnnOutputLayer, SubsamplingLayer, ZeroPaddingLayer)

__all__ = ["alexnet", "char_rnn", "googlenet", "lenet_mnist", "mlp_mnist",
           "resnet50", "vgg16"]


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


def vgg16(n_classes=1000, height=224, width=224, channels=3, seed=12345,
          learning_rate=0.01):
    """VGG-16 (the reference's TrainedModels.VGG16 zoo model)."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(learning_rate)
         .updater("nesterovs").momentum(0.9)
         .weight_init("relu")
         .list())
    for n_convs, ch in [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]:
        for _ in range(n_convs):
            b.layer(ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                     stride=(1, 1), padding=(1, 1),
                                     activation="relu"))
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)))
    b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    b.layer(OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"))
    return (b.set_input_type(InputType.convolutional(height, width, channels))
            .build())


def alexnet(n_classes=1000, height=224, width=224, channels=3, seed=12345,
            learning_rate=0.01):
    """AlexNet, one tower: 5 conv stages with LRN after the first two, 3
    max-pools, two 4096-wide dense layers with dropout."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(learning_rate)
         .updater("nesterovs").momentum(0.9)
         .weight_init("relu")
         .list()
         .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                 stride=(4, 4), padding=(2, 2),
                                 activation="relu"))
         .layer(LocalResponseNormalization())
         .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                 stride=(2, 2)))
         .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                 stride=(1, 1), padding=(2, 2),
                                 activation="relu"))
         .layer(LocalResponseNormalization())
         .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                 stride=(2, 2)))
         .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                 stride=(1, 1), padding=(1, 1),
                                 activation="relu"))
         .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                 stride=(1, 1), padding=(1, 1),
                                 activation="relu"))
         .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                 stride=(1, 1), padding=(1, 1),
                                 activation="relu"))
         .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                 stride=(2, 2)))
         .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(OutputLayer(n_out=n_classes, activation="softmax",
                            loss="mcxent")))
    return (b.set_input_type(InputType.convolutional(height, width, channels))
            .build())


def googlenet(n_classes=1000, height=224, width=224, channels=3, seed=12345,
              learning_rate=0.01):
    """GoogLeNet (Inception-v1) as a ComputationGraph: 9 inception modules
    whose four branches (1x1, 1x1 then 3x3, 1x1 then 5x5, max-pool then
    1x1) a MergeVertex concatenates; LRN in the stem; a global-average
    head with dropout, no auxiliary heads."""
    gb = (NeuralNetConfiguration.Builder()
          .seed(seed).learning_rate(learning_rate)
          .updater("nesterovs").momentum(0.9)
          .weight_init("relu")
          .graph_builder()
          .add_inputs("in"))

    def conv(name, inp, ch, k, s=(1, 1), pad=(0, 0)):
        gb.add_layer(name, ConvolutionLayer(
            n_out=ch, kernel_size=k, stride=s, padding=pad,
            activation="relu"), inp)
        return name

    def inception(name, inp, c1, c3r, c3, c5r, c5, cp):
        b1 = conv(f"{name}_1x1", inp, c1, (1, 1))
        b3 = conv(f"{name}_3x3", conv(f"{name}_3x3r", inp, c3r, (1, 1)),
                  c3, (3, 3), pad=(1, 1))
        b5 = conv(f"{name}_5x5", conv(f"{name}_5x5r", inp, c5r, (1, 1)),
                  c5, (5, 5), pad=(2, 2))
        gb.add_layer(f"{name}_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(1, 1),
            padding=(1, 1)), inp)
        bp = conv(f"{name}_poolproj", f"{name}_pool", cp, (1, 1))
        gb.add_vertex(f"{name}", MergeVertex(), b1, b3, b5, bp)
        return name

    def max_pool(name, inp):
        gb.add_layer(name, SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
            padding=(1, 1)), inp)
        return name

    top = conv("conv1", "in", 64, (7, 7), (2, 2), pad=(3, 3))
    max_pool("pool1", top)
    gb.add_layer("lrn1", LocalResponseNormalization(), "pool1")
    top = conv("conv2r", "lrn1", 64, (1, 1))
    top = conv("conv2", top, 192, (3, 3), pad=(1, 1))
    gb.add_layer("lrn2", LocalResponseNormalization(), top)
    max_pool("pool2", "lrn2")
    top = inception("i3a", "pool2", 64, 96, 128, 16, 32, 32)
    top = inception("i3b", top, 128, 128, 192, 32, 96, 64)
    max_pool("pool3", top)
    top = inception("i4a", "pool3", 192, 96, 208, 16, 48, 64)
    top = inception("i4b", top, 160, 112, 224, 24, 64, 64)
    top = inception("i4c", top, 128, 128, 256, 24, 64, 64)
    top = inception("i4d", top, 112, 144, 288, 32, 64, 64)
    top = inception("i4e", top, 256, 160, 320, 32, 128, 128)
    max_pool("pool4", top)
    top = inception("i5a", "pool4", 256, 160, 320, 32, 128, 128)
    top = inception("i5b", top, 384, 192, 384, 48, 128, 128)
    gb.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), top)
    gb.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                    loss="mcxent", dropout=0.4), "gap")
    return (gb.set_outputs("out")
            .set_input_types(InputType.convolutional(height, width, channels))
            .build())


def resnet50(n_classes=1000, height=224, width=224, channels=3, seed=12345,
             learning_rate=0.1, stages=(3, 4, 6, 3)):
    """ResNet-50 v1 as a ComputationGraph: bottleneck blocks with
    BatchNormalization and identity or projection shortcuts
    (ElementWiseVertex add); convs without bias (BN's beta takes its
    place); 25,557,032 parameters at the defaults. ``stages`` sets the
    blocks of each stage (fewer stages: a narrower net)."""
    gb = (NeuralNetConfiguration.Builder()
          .seed(seed).learning_rate(learning_rate)
          .updater("nesterovs").momentum(0.9)
          .weight_init("relu")
          .graph_builder()
          .add_inputs("in"))

    def conv_bn(name, inp, ch, k, s, pad=(0, 0), act="relu"):
        gb.add_layer(f"{name}_conv", ConvolutionLayer(
            n_out=ch, kernel_size=k, stride=s, padding=pad,
            activation="identity", has_bias=False), inp)
        gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
        if act is None:
            return f"{name}_bn"
        gb.add_layer(f"{name}_relu", ActivationLayer(activation=act),
                     f"{name}_bn")
        return f"{name}_relu"

    # stem: 7x7/2 conv (pad 3), BN, relu, 3x3/2 max-pool (pad 1)
    gb.add_layer("pad1", ZeroPaddingLayer(padding=(3, 3)), "in")
    top = conv_bn("conv1", "pad1", 64, (7, 7), (2, 2))
    gb.add_layer("pool1_pad", ZeroPaddingLayer(padding=(1, 1)), top)
    gb.add_layer("pool1", SubsamplingLayer(pooling_type="max",
                                           kernel_size=(3, 3),
                                           stride=(2, 2)), "pool1_pad")
    top = "pool1"
    for stage_idx, n_blocks in enumerate(stages):
        ch_mid = 64 * (2 ** stage_idx)
        ch_out = ch_mid * 4
        for block in range(n_blocks):
            stride = (2, 2) if (block == 0 and stage_idx > 0) else (1, 1)
            name = f"s{stage_idx}b{block}"
            # main branch: 1x1/stride, 3x3 pad 1, 1x1 (no relu after it)
            a = conv_bn(f"{name}_a", top, ch_mid, (1, 1), stride)
            bmid = conv_bn(f"{name}_b", a, ch_mid, (3, 3), (1, 1),
                           pad=(1, 1))
            c = conv_bn(f"{name}_c", bmid, ch_out, (1, 1), (1, 1), act=None)
            # shortcut: a 1x1/stride projection at a stage's entry
            if block == 0:
                sc = conv_bn(f"{name}_sc", top, ch_out, (1, 1), stride,
                             act=None)
            else:
                sc = top
            gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, sc)
            gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                         f"{name}_add")
            top = f"{name}_out"
    gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), top)
    gb.add_layer("fc", OutputLayer(n_out=n_classes, activation="softmax",
                                   loss="mcxent"), "avgpool")
    gb.set_outputs("fc")
    gb.set_input_types(InputType.convolutional(height, width, channels))
    return gb.build()
