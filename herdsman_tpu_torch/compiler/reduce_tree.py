"""Reduce-tree construction — faithful reimplementation of the reference's
three reduce policies (reference src/service/execution_service.cpp:560-688):

- SEQUENCED:     one task consuming all input partitions.
- PARALLEL:      one intermediate task per partition, then one final combine.
- PARALLEL_FULL: k-ary tree (fan-in per_node_count, default 2); each merge
  layer groups exactly k nodes and PROMOTES the remainder unchanged to the
  next layer (reference :664-686 max_full_child_index logic); the final
  output node consumes the <= k survivors.

The tree drives both task accounting (completion releases children whose
dependency count hits zero, reference :691-705) and the device fold order
(the combiner circuit need not be associative, so the tree shape is part of
the semantics).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from herdsman_tpu_torch.circuit.dag import DAG, Node
from herdsman_tpu_torch.circuit.plan import Policy


@dataclasses.dataclass
class ReduceNode:
    """(frame, row_count, partition) + dependency counter — the herd_common
    ReduceNode analog (reference include/service/execution_service.hpp:112-131)."""

    frame: str              # "input" | "hidden" | "output" (logical frame)
    row_count: int
    partition: int
    unresolved_dependencies: int
    is_task: bool = False   # input-layer nodes are data, not tasks


@dataclasses.dataclass
class ReduceTree:
    tree: DAG[ReduceNode]
    initial_pending: list[int]     # node ids runnable immediately
    hidden_frame_rows: int         # rows/partitions of the hidden frame
    output_node: int

    def total_tasks(self) -> int:
        return sum(1 for n in self.tree if n.value.is_task)

    def mark_completed(self, node_id: int) -> list[int]:
        """Decrement children deps; return newly-released node ids
        (reference src/service/execution_service.cpp:691-705)."""
        released = []
        for child in self.tree[node_id].children():
            child.value.unresolved_dependencies -= 1
            if child.value.unresolved_dependencies == 0:
                released.append(child.node_id())
        return released


def build_reduce_tree(
    partition_sizes: list[int],
    policy: Policy,
    per_node_count: Optional[int] = None,
) -> ReduceTree:
    partitions = len(partition_sizes)
    tree: DAG[ReduceNode] = DAG()
    pending: list[int] = []

    input_layer: list[Node[ReduceNode]] = [
        tree.emplace(ReduceNode("input", partition_sizes[i], i, 0))
        for i in range(partitions)
    ]

    if policy == Policy.SEQUENCED:
        out = tree.emplace(ReduceNode("output", 1, 0, partitions, is_task=True))
        for node in input_layer:
            tree.add_edge(node, out)
        pending.append(out.node_id())
        return ReduceTree(tree, pending, 0, out.node_id())

    if policy == Policy.PARALLEL:
        out = tree.emplace(ReduceNode("output", 1, 0, partitions, is_task=True))
        # hidden frame: `partitions` rows in `partitions` partitions
        # (reference :604-610)
        for i in range(partitions):
            node = tree.emplace(ReduceNode("hidden", partitions, i, 0,
                                           is_task=True))
            tree.add_edge(input_layer[i], node)
            tree.add_edge(node, out)
            pending.append(node.node_id())
        return ReduceTree(tree, pending, partitions, out.node_id())

    assert policy == Policy.PARALLEL_FULL
    k = per_node_count if per_node_count is not None else 2
    # hidden-frame size accounting (reference :628-640)
    current_level_count = partitions
    node_sum = current_level_count
    while current_level_count > k:
        remaining = current_level_count % k
        current_level_count = int(
            math.floor(float(current_level_count) / float(k))
        )
        current_level_count += remaining
        node_sum += current_level_count

    partition_index = 0
    current_layer: list[Node[ReduceNode]] = []
    for i in range(partitions):
        node = tree.emplace(ReduceNode("hidden", 1, partition_index, 0,
                                       is_task=True))
        tree.add_edge(input_layer[i], node)
        pending.append(node.node_id())
        current_layer.append(node)
        partition_index += 1

    while len(current_layer) > k:
        prev = current_layer
        current_layer = []
        max_full = len(prev) - len(prev) % k
        for i in range(0, max_full, k):
            node = tree.emplace(ReduceNode("hidden", 1, partition_index, k,
                                           is_task=True))
            current_layer.append(node)
            for j in range(k):
                tree.add_edge(prev[i + j], node)
            partition_index += 1
        for i in range(max_full, len(prev)):
            current_layer.append(prev[i])  # remainder promoted unchanged

    out = tree.emplace(
        ReduceNode("output", 1, 0, len(current_layer), is_task=True)
    )
    for node in current_layer:
        tree.add_edge(node, out)
    return ReduceTree(tree, pending, node_sum, out.node_id())
