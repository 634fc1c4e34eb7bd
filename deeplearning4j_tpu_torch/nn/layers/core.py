"""Core feed-forward layers: the port of
``deeplearning4j_tpu/nn/layers/core.py`` (Dense, the output family with
CenterLossOutputLayer, Activation, Dropout, Embedding). Forward math is
``z = x @ W + b`` with ``W`` ``[n_in, n_out]``, the reference's layout;
autograd supplies the backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import (FeedForward,
                                                         Recurrent)
from deeplearning4j_tpu_torch.nn.layers.base import (BaseLayer,
                                                     FeedForwardLayer,
                                                     register_layer)
from deeplearning4j_tpu_torch.ops import losses as losses_mod

__all__ = ["ActivationLayer", "BaseOutputLayer", "CenterLossOutputLayer",
           "DenseLayer", "DropoutLayer", "EmbeddingLayer", "LossLayer",
           "OutputLayer", "RnnOutputLayer"]


@register_layer
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully connected layer."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def set_input_type(self, input_type):
        if self.n_in is None:
            if isinstance(input_type, FeedForward):
                self.n_in = input_type.size
            elif hasattr(input_type, "flattened_size"):
                self.n_in = input_type.flattened_size
            else:
                raise ValueError(f"{type(self).__name__} got non-FF input "
                                 f"{input_type}")
        return self.output_type(input_type)

    def output_type(self, input_type):
        return FeedForward(self.n_out)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    @property
    def param_order(self):
        return ["W", "b"]

    def init_params(self, generator, dtype=torch.float32):
        return {"W": self._init_weight(generator, (self.n_in, self.n_out),
                                       dtype=dtype),
                "b": self._init_bias(generator, (self.n_out,), dtype=dtype)}

    def pre_output(self, params, x):
        return x @ params["W"] + params["b"]

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.apply_dropout(x, train=train, rng=rng)
        return self.activation_fn()(self.pre_output(params, x)), state


@register_layer
@dataclass
class BaseOutputLayer(DenseLayer):
    """Dense + loss; ``loss`` names an ``ops.losses`` function."""

    loss: str = "mcxent"

    def compute_per_example_loss(self, labels, preout, mask=None):
        return losses_mod.get(self.loss)(labels, preout,
                                         self.activation or "identity",
                                         mask=mask)

    def compute_score(self, labels, preout, mask=None, average=True):
        return losses_mod.compute_score(self.loss, labels, preout,
                                        self.activation or "identity",
                                        mask=mask, average=average)


@register_layer
@dataclass
class OutputLayer(BaseOutputLayer):
    pass


@register_layer
@dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Output layer applied at every time step ([batch, time, size] input);
    the loss masks by the per-time-step mask."""

    def set_input_type(self, input_type):
        if self.n_in is None:
            if isinstance(input_type, (Recurrent, FeedForward)):
                self.n_in = input_type.size
            else:
                raise ValueError(f"RnnOutputLayer got {input_type}")
        return self.output_type(input_type)

    def output_type(self, input_type):
        t = input_type.timeseries_length \
            if isinstance(input_type, Recurrent) else None
        return Recurrent(self.n_out, t)


@register_layer
@dataclass
class LossLayer(BaseLayer):
    """Loss without params: the input is the prediction."""

    loss: str = "mcxent"

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.activation_fn()(x), state

    def compute_per_example_loss(self, labels, preout, mask=None):
        return losses_mod.get(self.loss)(labels, preout,
                                         self.activation or "identity",
                                         mask=mask)

    def compute_score(self, labels, preout, mask=None, average=True):
        return losses_mod.compute_score(self.loss, labels, preout,
                                        self.activation or "identity",
                                        mask=mask, average=average)


@register_layer
@dataclass
class CenterLossOutputLayer(BaseOutputLayer):
    """Output layer with a center loss (CenterLossOutputLayer.java): one
    center per class in layer state, ``center_loss`` = alpha/2 times the
    mean squared distance of each example's features to its class
    center, and ``update_centers`` moving each present class's center
    toward its batch mean at rate ``lambda_``. As in the reference, the
    networks call neither: the layer trains and scores as an
    OutputLayer."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_state(self):
        return {"centers": torch.zeros((self.n_out, self.n_in),
                                       dtype=torch.float32)}

    def center_loss(self, state, features, labels):
        assigned = labels @ state["centers"]   # one-hot rows pick a center
        return 0.5 * self.alpha * ((features - assigned) ** 2).sum(-1).mean()

    def update_centers(self, state, features, labels):
        centers = state["centers"]
        present = labels.sum(0)
        batch_means = (labels.T @ features) / \
            torch.clamp(present, min=1.0)[:, None]
        moved = (1 - self.lambda_) * centers + self.lambda_ * batch_means
        return {**state, "centers": torch.where((present > 0)[:, None],
                                                moved, centers)}


@register_layer
@dataclass
class ActivationLayer(BaseLayer):
    """Applies an activation only."""

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.activation_fn()(x), state


@register_layer
@dataclass
class DropoutLayer(BaseLayer):
    """Standalone dropout; identity at inference."""

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.apply_dropout(x, train=train, rng=rng), state


@register_layer
@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index -> row lookup (EmbeddingLayer.java): integer ids shaped
    [batch] or [batch, 1], given as integers or as floats holding them
    (the networks keep them out of the compute-dtype cast)."""

    n_in: Optional[int] = None   # vocabulary size
    n_out: Optional[int] = None

    def set_input_type(self, input_type):
        if self.n_in is None and isinstance(input_type, FeedForward):
            self.n_in = input_type.size
        return FeedForward(self.n_out)

    def output_type(self, input_type):
        return FeedForward(self.n_out)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    @property
    def param_order(self):
        return ["W", "b"]

    def init_params(self, generator, dtype=torch.float32):
        return {"W": self._init_weight(generator, (self.n_in, self.n_out),
                                       dtype=dtype),
                "b": self._init_bias(generator, (self.n_out,), dtype=dtype)}

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        idx = x.to(torch.int64)
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        emb = params["W"][idx]
        return self.activation_fn()(emb + params["b"]), state
