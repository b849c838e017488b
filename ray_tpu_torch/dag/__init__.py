"""ray_tpu_torch.dag — lazy DAG authoring + compiled execution.

Parity: python/ray/dag/ (InputNode/MultiOutputNode/bind;
CompiledDAG via dag.experimental_compile()).
"""

from .compiled_dag import CompiledDAG, CompiledDAGRef
from .dag_node import (
    ClassMethodNode,
    CollectiveOutputNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    allreduce,
)

__all__ = [
    "ClassMethodNode",
    "CollectiveOutputNode",
    "allreduce",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGNode",
    "FunctionNode",
    "InputAttributeNode",
    "InputNode",
    "MultiOutputNode",
]
