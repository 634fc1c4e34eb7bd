"""ComputationGraphConfiguration and GraphBuilder: the port of
``deeplearning4j_tpu/nn/conf/computation_graph.py``
(``ComputationGraphConfiguration.java``).

The same builder (``add_inputs``, ``add_layer``, ``add_vertex``,
``set_outputs``, ``set_input_types``), the same structural checks, the
same topological order and the same shape inference with automatic
preprocessors on layer vertices (the MultiLayerConfiguration's, walked
over the DAG), and the same JSON: one string builds a graph in either
package. The topological order is the reference's Kahn order with its
sorted ready list; it fixes ``layer_confs()``, and so the flat parameter
vector, ``params()``/``set_params()`` and an archive's coefficients.

``to_yaml``/``from_yaml`` write and read the same dict through PyYAML,
imported when they are called.
"""

from __future__ import annotations

import json

from deeplearning4j_tpu_torch.nn.conf.graph import (GraphVertex,
                                                    vertex_from_dict)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    preprocessor_from_dict
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, layer_from_dict

__all__ = ["ComputationGraphConfiguration", "GraphBuilder", "LayerVertex"]


class LayerVertex:
    """A layer on a graph node, with an optional input preprocessor
    (nn/conf/graph/LayerVertex.java)."""

    def __init__(self, layer: BaseLayer, preprocessor=None):
        self.layer = layer
        self.preprocessor = preprocessor

    def to_dict(self):
        d = {"type": "LayerVertex", "layer": self.layer.to_dict()}
        if self.preprocessor is not None:
            d["preprocessor"] = self.preprocessor.to_dict()
        return d

    @staticmethod
    def from_dict(d):
        pre = d.get("preprocessor")
        return LayerVertex(layer_from_dict(d["layer"]),
                           None if pre is None else preprocessor_from_dict(pre))


class ComputationGraphConfiguration:
    """DAG network configuration (ComputationGraphConfiguration.java)."""

    def __init__(self, *, network_inputs, network_outputs, vertices,
                 vertex_inputs, seed=12345, iterations=1,
                 optimization_algo="stochastic_gradient_descent",
                 minimize=True, backprop=True, pretrain=False,
                 backprop_type="standard", tbptt_fwd_length=20,
                 tbptt_back_length=20, input_types=None,
                 use_regularization=False, max_iterations=10000,
                 compute_dtype="float32", remat=False):
        self.network_inputs: list[str] = list(network_inputs)
        self.network_outputs: list[str] = list(network_outputs)
        # name -> LayerVertex | GraphVertex
        self.vertices: dict[str, object] = dict(vertices)
        self.vertex_inputs: dict[str, list[str]] = {
            k: list(v) for k, v in vertex_inputs.items()}
        self.seed = seed
        self.iterations = iterations
        self.optimization_algo = optimization_algo
        self.minimize = minimize
        self.backprop = backprop
        self.pretrain = pretrain
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.input_types = input_types
        self.use_regularization = use_regularization
        self.max_iterations = max_iterations
        self.compute_dtype = compute_dtype
        # recompute each layer's activations in the backward
        # (torch.utils.checkpoint per layer vertex)
        self.remat = bool(remat)
        self.validate()
        self.topological_order = self._topological_sort()
        if input_types is not None:
            self._setup_shapes(input_types)

    def validate(self):
        """Structural checks (ComputationGraphConfiguration.validate())."""
        names = set(self.network_inputs) | set(self.vertices)
        dup = set(self.network_inputs) & set(self.vertices)
        if dup:
            raise ValueError(f"Vertex names collide with input names: "
                             f"{sorted(dup)}")
        for name, ins in self.vertex_inputs.items():
            if name not in self.vertices:
                raise ValueError(f"vertex_inputs for unknown vertex {name!r}")
            for i in ins:
                if i not in names:
                    raise ValueError(f"Vertex {name!r} references unknown "
                                     f"input {i!r}")
        for name in self.vertices:
            if not self.vertex_inputs.get(name):
                raise ValueError(f"Vertex {name!r} has no inputs")
        for o in self.network_outputs:
            if o not in self.vertices:
                raise ValueError(f"Network output {o!r} is not a vertex")
        if not self.network_outputs:
            raise ValueError("No network outputs set")

    def _topological_sort(self) -> list[str]:
        """Kahn's algorithm over the vertices
        (ComputationGraph.topologicalSortOrder:286), the network inputs
        being implicit sources; the ready list is kept sorted by name.
        Vertex names only, in evaluation order."""
        indeg = {}
        children: dict[str, list[str]] = {}
        for name, ins in self.vertex_inputs.items():
            indeg[name] = sum(1 for i in ins if i in self.vertices)
            for i in ins:
                if i in self.vertices:
                    children.setdefault(i, []).append(name)
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in sorted(children.get(n, [])):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
            ready.sort()
        if len(order) != len(self.vertices):
            cyc = sorted(set(self.vertices) - set(order))
            raise ValueError(f"Cycle in computation graph involving: {cyc}")
        return order

    def _setup_shapes(self, input_types):
        """Infer layer sizes and insert preprocessors along the DAG
        (setInputTypes, ComputationGraphConfiguration.java:277)."""
        if len(input_types) != len(self.network_inputs):
            raise ValueError(f"Got {len(input_types)} input types for "
                             f"{len(self.network_inputs)} network inputs")
        types: dict[str, InputType] = dict(zip(self.network_inputs,
                                               input_types))
        for name in self.topological_order:
            v = self.vertices[name]
            in_types = [types[i] for i in self.vertex_inputs[name]]
            if isinstance(v, LayerVertex):
                t = in_types[0]
                if v.preprocessor is None:
                    v.preprocessor = MultiLayerConfiguration \
                        ._auto_preprocessor(t, v.layer)
                if v.preprocessor is not None:
                    t = v.preprocessor.output_type(t)
                types[name] = v.layer.set_input_type(t)
            else:
                types[name] = v.output_type(*in_types)
        self.vertex_output_types = types

    def layer_confs(self) -> list[BaseLayer]:
        """Layer configurations in topological order: the flattening order
        of params()/set_params() (ComputationGraph's flat params
        :311-345)."""
        return [self.vertices[n].layer for n in self.layer_names()]

    def layer_names(self) -> list[str]:
        return [n for n in self.topological_order
                if isinstance(self.vertices[n], LayerVertex)]

    def to_dict(self):
        return {
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "vertices": {k: v.to_dict() for k, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "seed": self.seed,
            "iterations": self.iterations,
            "optimization_algo": self.optimization_algo,
            "minimize": self.minimize,
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_types": None if self.input_types is None
            else [t.to_dict() for t in self.input_types],
            "use_regularization": self.use_regularization,
            "max_iterations": self.max_iterations,
            "compute_dtype": self.compute_dtype,
            "remat": self.remat,
        }

    def to_json(self):
        return json.dumps(self.to_dict(), indent=2)

    def to_yaml(self):
        import yaml
        return yaml.safe_dump(self.to_dict())

    @staticmethod
    def from_dict(d):
        d = dict(d)
        vertices = {}
        for k, vd in d.pop("vertices").items():
            vertices[k] = LayerVertex.from_dict(vd) \
                if vd["type"] == "LayerVertex" else vertex_from_dict(vd)
        it = d.pop("input_types", None)
        conf = ComputationGraphConfiguration(
            network_inputs=d.pop("network_inputs"),
            network_outputs=d.pop("network_outputs"),
            vertices=vertices, vertex_inputs=d.pop("vertex_inputs"), **d)
        if it is not None:
            conf.input_types = [InputType.from_dict(t) for t in it]
            conf._setup_shapes(conf.input_types)
        return conf

    @staticmethod
    def from_json(s):
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    @staticmethod
    def from_yaml(s):
        import yaml
        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))


class GraphBuilder:
    """The fluent DAG builder (ComputationGraphConfiguration.GraphBuilder
    :424)."""

    def __init__(self, global_conf):
        self._global = global_conf
        self._inputs: list[str] = []
        self._outputs: list[str] = []
        self._vertices: dict[str, object] = {}
        self._vertex_inputs: dict[str, list[str]] = {}
        self._input_types = None
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names):
        self._inputs.extend(names)
        return self

    def add_layer(self, name, layer, *inputs, preprocessor=None):
        """addLayer(name, layer, [preprocessor,] inputs...) (:530): the
        global hyperparameters cascade into a copy of ``layer``."""
        if not isinstance(layer, BaseLayer):
            raise ValueError(f"layer must be a BaseLayer, got {type(layer)}")
        layer = layer.copy()
        layer.apply_global_defaults(self._global.as_cascade_dict())
        if not self._global.use_regularization:
            layer.l1 = layer.l2 = layer.l1_bias = layer.l2_bias = 0.0
        self._vertices[name] = LayerVertex(layer, preprocessor)
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name, vertex, *inputs):
        if not isinstance(vertex, GraphVertex):
            raise ValueError(f"vertex must be a GraphVertex, got "
                             f"{type(vertex)}")
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names):
        self._outputs = list(names)
        return self

    def set_input_types(self, *types):
        self._input_types = list(types)
        return self

    def backprop(self, flag):
        self._backprop = flag
        return self

    def pretrain(self, flag):
        self._pretrain = flag
        return self

    def backprop_type(self, t):
        self._backprop_type = str(t).lower()
        return self

    def tbptt_fwd_length(self, n):
        self._tbptt_fwd = n
        return self

    def tbptt_back_length(self, n):
        self._tbptt_back = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        g = self._global
        return ComputationGraphConfiguration(
            network_inputs=self._inputs, network_outputs=self._outputs,
            vertices=self._vertices, vertex_inputs=self._vertex_inputs,
            seed=g.seed_, iterations=g.iterations_,
            optimization_algo=g.optimization_algo_, minimize=g.minimize_,
            backprop=self._backprop, pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_types=self._input_types,
            use_regularization=g.use_regularization,
            max_iterations=g.max_iterations_,
            compute_dtype=g.compute_dtype_, remat=g.remat_)
