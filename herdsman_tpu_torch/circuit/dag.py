"""Generic DAG with the herd_common surface.

Reimplements (from usage-site reconstruction, SURVEY.md §2.4; the herd_common
submodule is empty in the reference snapshot) the `herd::common::DAG<T>`
interface herdsman exercises: emplace -> node handle, add_edge, operator[],
source_nodes, parents()/children()/node_id()/value(), iteration over nodes
(reference src/service/execution_service.cpp:242-309, 586-705,
src/execution/execution_plan/execution_plan_analyzer.cpp:6-22).
"""

from __future__ import annotations

from typing import Generic, Iterator, TypeVar

T = TypeVar("T")


class Node(Generic[T]):
    """Handle to a DAG node (stable across DAG mutation)."""

    __slots__ = ("_dag", "_id")

    def __init__(self, dag: "DAG[T]", node_id: int):
        self._dag = dag
        self._id = node_id

    def node_id(self) -> int:
        return self._id

    @property
    def value(self) -> T:
        return self._dag._values[self._id]

    @value.setter
    def value(self, v: T) -> None:
        self._dag._values[self._id] = v

    def parents(self) -> list["Node[T]"]:
        return [Node(self._dag, i) for i in self._dag._parents[self._id]]

    def children(self) -> list["Node[T]"]:
        return [Node(self._dag, i) for i in self._dag._children[self._id]]

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Node)
            and other._dag is self._dag
            and other._id == self._id
        )

    def __hash__(self) -> int:
        return hash((id(self._dag), self._id))

    def __repr__(self) -> str:
        return f"Node({self._id}: {self.value!r})"


class DAG(Generic[T]):
    def __init__(self) -> None:
        self._values: list[T] = []
        self._parents: list[list[int]] = []
        self._children: list[list[int]] = []

    def emplace(self, value: T) -> Node[T]:
        self._values.append(value)
        self._parents.append([])
        self._children.append([])
        return Node(self, len(self._values) - 1)

    def add_edge(self, src: Node[T] | int, dst: Node[T] | int) -> None:
        s = src.node_id() if isinstance(src, Node) else src
        d = dst.node_id() if isinstance(dst, Node) else dst
        self._children[s].append(d)
        self._parents[d].append(s)

    def __getitem__(self, node_id: int) -> Node[T]:
        if not 0 <= node_id < len(self._values):
            raise IndexError(node_id)
        return Node(self, node_id)

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self) -> Iterator[Node[T]]:
        return (Node(self, i) for i in range(len(self._values)))

    def source_nodes(self) -> list[Node[T]]:
        return [
            Node(self, i)
            for i in range(len(self._values))
            if not self._parents[i]
        ]

    def sink_nodes(self) -> list[Node[T]]:
        return [
            Node(self, i)
            for i in range(len(self._values))
            if not self._children[i]
        ]

    def topological_order(self) -> list[Node[T]]:
        """Kahn order; raises ValueError on cycles."""
        indeg = [len(p) for p in self._parents]
        frontier = [i for i, d in enumerate(indeg) if d == 0]
        order: list[int] = []
        while frontier:
            i = frontier.pop()
            order.append(i)
            for c in self._children[i]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    frontier.append(c)
        if len(order) != len(self._values):
            raise ValueError("DAG contains a cycle")
        return [Node(self, i) for i in order]
