"""The fusion graph compiler (DESIGN.md §8), ported from ``repro.graph``:
typed IR, tracer, passes and the single-device ExecutionPlan.

Layout:
  ir      — TensorSpec/ParamRef + the node types + Graph
  trace   — TracedArray tracer over the hooked functional layer
  passes  — fuse_conv_blocks / lower_quant / eliminate_dead_quantize /
            place_channel_parallel
  plan    — ExecutionPlan / BoundPlan / compile_model
"""
from repro_torch.graph.ir import (Conv2DNode, DenseNode, FlattenNode,
                                  FusedConvBlockNode, Graph, InputNode,
                                  MaxPool2Node, Node, ParamRef, QuantizeNode,
                                  ReluNode, ShardingSpec, TensorSpec)
from repro_torch.graph.trace import (GraphBuilder, TracedArray, param_refs,
                                     trace)
from repro_torch.graph.passes import (default_passes, eliminate_dead_quantize,
                                      fuse_conv_blocks, lower_quant,
                                      place_channel_parallel,
                                      stage_arith_intensity)
from repro_torch.graph.plan import BoundPlan, ExecutionPlan, compile_model

__all__ = [
    "TensorSpec", "ParamRef", "ShardingSpec", "Node", "InputNode",
    "Conv2DNode", "ReluNode", "MaxPool2Node", "FlattenNode", "DenseNode",
    "QuantizeNode", "FusedConvBlockNode", "Graph",
    "GraphBuilder", "TracedArray", "param_refs", "trace",
    "default_passes", "eliminate_dead_quantize", "fuse_conv_blocks",
    "lower_quant", "place_channel_parallel", "stage_arith_intensity",
    "BoundPlan", "ExecutionPlan", "compile_model",
]
