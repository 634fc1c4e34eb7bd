"""Graph vertices, ComputationGraph's parameter-free DAG nodes: the port of
``deeplearning4j_tpu/nn/conf/graph.py`` (``nn/conf/graph/*`` and
``nn/graph/vertex/impl/*``).

The same 13 vertices under the same names and fields, so a graph's JSON
names them alike in both packages: Merge, ElementWise
(add/subtract/product/average/max), Subset, Stack, Unstack, Scale, Shift,
L2, L2Normalize, Preprocessor, LastTimeStep, DuplicateToTimeSeries and
Reshape. Layouts are the reference's: features on the last axis (NHWC
images, [batch, time, size] sequences), so Merge concatenates on the last
axis and Subset slices it. ``forward`` takes the input activations (and
their time masks) as tensors; autograd gives the backward. A layer on a
node is a ``LayerVertex`` (``nn/conf/computation_graph.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import (Convolutional,
                                                         FeedForward,
                                                         InputType,
                                                         Recurrent)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    preprocessor_from_dict

__all__ = ["DuplicateToTimeSeriesVertex", "ElementWiseVertex", "GraphVertex",
           "L2NormalizeVertex", "L2Vertex", "LastTimeStepVertex",
           "MergeVertex", "PreprocessorVertex", "ReshapeVertex",
           "ScaleVertex", "ShiftVertex", "StackVertex", "SubsetVertex",
           "UnstackVertex", "VERTEX_REGISTRY", "register_vertex",
           "vertex_from_dict"]

VERTEX_REGISTRY: dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d):
    d = dict(d)
    name = d.pop("type")
    if name not in VERTEX_REGISTRY:
        raise ValueError(f"Unknown vertex type {name!r}. Known: "
                         f"{sorted(VERTEX_REGISTRY)}")
    cls = VERTEX_REGISTRY[name]
    if cls is PreprocessorVertex and d.get("preprocessor") is not None:
        d["preprocessor"] = preprocessor_from_dict(d["preprocessor"])
    return cls(**d)


@dataclass
class GraphVertex:
    """Parameter-free DAG node (nn/graph/vertex/GraphVertex)."""

    def to_dict(self):
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                d[f.name] = v
        return d

    def copy(self, **overrides):
        return dataclasses.replace(self, **overrides)

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def forward(self, inputs, masks=None):
        """``inputs``: the input activations; ``masks``: their time masks
        (entries may be None)."""
        raise NotImplementedError

    def feed_forward_mask(self, masks):
        """The output's mask: the first input mask that is set."""
        for m in masks or []:
            if m is not None:
                return m
        return None


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenation on the feature axis (MergeVertex.java): FF and RNN
    sizes add, CNN channels add (NHWC: the last axis everywhere)."""

    def output_type(self, *its):
        first = its[0]
        if isinstance(first, FeedForward):
            return FeedForward(sum(i.size for i in its))
        if isinstance(first, Recurrent):
            return Recurrent(sum(i.size for i in its),
                             first.timeseries_length)
        if isinstance(first, Convolutional):
            return Convolutional(first.height, first.width,
                                 sum(i.channels for i in its))
        return first

    def forward(self, inputs, masks=None):
        if len(inputs) == 1:
            return inputs[0]
        return torch.cat(inputs, dim=-1)


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise add, subtract, product, average or max
    (ElementWiseVertex.java:40; subtract takes exactly 2 inputs)."""

    op: str = "add"

    def forward(self, inputs, masks=None):
        op = self.op.lower()
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("ElementWiseVertex(subtract) needs exactly "
                                 "2 inputs")
            return inputs[0] - inputs[1]
        out = inputs[0]
        for x in inputs[1:]:
            if op in ("add", "average"):
                out = out + x
            elif op == "product":
                out = out * x
            elif op == "max":
                out = torch.maximum(out, x)
            else:
                raise ValueError(f"Unknown ElementWiseVertex op {self.op!r}")
        if op == "average":
            out = out / len(inputs)
        return out


@register_vertex
@dataclass
class SubsetVertex(GraphVertex):
    """Feature-axis slice [from, to], both ends included
    (SubsetVertex.java)."""

    from_index: int = 0
    to_index: int = 0

    def output_type(self, *its):
        n = self.to_index - self.from_index + 1
        it = its[0]
        if isinstance(it, Recurrent):
            return Recurrent(n, it.timeseries_length)
        if isinstance(it, Convolutional):
            return Convolutional(it.height, it.width, n)
        return FeedForward(n)

    def forward(self, inputs, masks=None):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclass
class StackVertex(GraphVertex):
    """Stack along the batch axis (StackVertex.java)."""

    def forward(self, inputs, masks=None):
        return torch.cat(inputs, dim=0)

    def feed_forward_mask(self, masks):
        if masks and all(m is not None for m in masks):
            return torch.cat(masks, dim=0)
        return None


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """StackVertex's inverse: chunk ``from_index`` of ``stack_size`` equal
    batch chunks (UnstackVertex.java)."""

    from_index: int = 0
    stack_size: int = 1

    def forward(self, inputs, masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]

    def feed_forward_mask(self, masks):
        m = masks[0] if masks else None
        if m is None:
            return None
        step = m.shape[0] // self.stack_size
        return m[self.from_index * step:(self.from_index + 1) * step]


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar (ScaleVertex.java)."""

    scale_factor: float = 1.0

    def forward(self, inputs, masks=None):
        return inputs[0] * self.scale_factor


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    """Add a fixed scalar (ShiftVertex.java)."""

    shift_factor: float = 0.0

    def forward(self, inputs, masks=None):
        return inputs[0] + self.shift_factor


@register_vertex
@dataclass
class L2Vertex(GraphVertex):
    """The L2 distance of two inputs, [batch, 1] (L2Vertex.java; ``eps``
    keeps the square root's gradient finite at 0)."""

    eps: float = 1e-8

    def output_type(self, *its):
        return FeedForward(1)

    def forward(self, inputs, masks=None):
        a = inputs[0].reshape(inputs[0].shape[0], -1)
        b = inputs[1].reshape(inputs[1].shape[0], -1)
        sq = ((a - b) ** 2).sum(dim=1, keepdim=True)
        return torch.sqrt(sq + self.eps)


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over all but the batch axis (L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def forward(self, inputs, masks=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt((flat ** 2).sum(dim=1) + self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.ndim - 1))


@register_vertex
@dataclass
class PreprocessorVertex(GraphVertex):
    """An InputPreProcessor as a vertex of its own
    (PreprocessorVertex.java)."""

    preprocessor: object = None

    def to_dict(self):
        return {"type": "PreprocessorVertex",
                "preprocessor": self.preprocessor.to_dict()}

    def output_type(self, *its):
        return self.preprocessor.output_type(its[0])

    def forward(self, inputs, masks=None):
        m = masks[0] if masks else None
        return self.preprocessor.pre_process(inputs[0], m)

    def feed_forward_mask(self, masks):
        m = masks[0] if masks else None
        return self.preprocessor.feed_forward_mask(m)


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """RNN [b, t, s] -> FF [b, s]: each example's last step, under the mask
    of the network input named ``mask_input_name``
    (rnn/LastTimeStepVertex.java)."""

    mask_input_name: Optional[str] = None

    def output_type(self, *its):
        return FeedForward(its[0].size)

    def forward(self, inputs, masks=None):
        x = inputs[0]
        m = masks[0] if masks else None
        if m is None:
            return x[:, -1, :]
        # the last step whose mask is set (pre-padded masks too):
        # argmax gives the first maximum of the reversed mask
        t = x.shape[1]
        rev = torch.flip(m > 0, dims=(1,)).to(torch.int32)
        idx = t - 1 - torch.argmax(rev, dim=1)
        return x[torch.arange(x.shape[0], device=x.device), idx, :]

    def feed_forward_mask(self, masks):
        return None


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """FF [b, s] -> RNN [b, t, s], with t from the network input named
    ``ts_input_name`` (rnn/DuplicateToTimeSeriesVertex.java); the graph
    hands that input over as the second one."""

    ts_input_name: Optional[str] = None

    def output_type(self, *its):
        t = None
        for it in its[1:]:
            if isinstance(it, Recurrent):
                t = it.timeseries_length
        return Recurrent(its[0].size, t)

    def forward(self, inputs, masks=None):
        x = inputs[0]
        t = inputs[1].shape[1]
        return x[:, None, :].expand(x.shape[0], t, x.shape[1])

    def feed_forward_mask(self, masks):
        if masks and len(masks) > 1:
            return masks[1]
        return None


@register_vertex
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape to a fixed shape behind the batch axis (the later
    reference's ReshapeVertex)."""

    shape: Optional[tuple] = None

    def forward(self, inputs, masks=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))
