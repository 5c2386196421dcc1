"""Type aliases and relation-key helpers.

Mirrors the semantics of the reference's type layer
(reference src/utils/types.rs:4-34): ``NodeType``/``RelType`` are strings
at the API boundary, ``EdgeType`` is a ``(src, rel, dst)`` triple, and the
canonical relation key is ``"src__rel__dst"``.

Strings never enter the compute path.  ``TypeIndex``
enumerates node/edge types into dense integer ids at ingest (see
reference src/algo/neighbor_sampling.rs:255-258 where the reference keeps
strings in its hot loop); all device code works on integer type ids.
A copy of ``tch_geometric_tpu/utils/types.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

NodeType = str
RelType = str
EdgeType = Tuple[str, str, str]

# Sentinel used throughout for "missing" timestamps, matching the reference's
# NAN_TIMESTAMP (reference src/algo/hgt_sampling.rs:11).
NAN_TIMESTAMP = -1


def rel_key(edge_type: EdgeType) -> RelType:
    """``(src, rel, dst) -> "src__rel__dst"`` (src/python.rs rel-key scheme)."""
    return f"{edge_type[0]}__{edge_type[1]}__{edge_type[2]}"


def split_rel_key(key: RelType) -> EdgeType:
    src, rel, dst = key.split("__")
    return (src, rel, dst)


def to_edge_types(edge_types: Sequence[EdgeType]) -> Dict[RelType, EdgeType]:
    """Relation-key -> edge-type triple map (neighbor_sampling.rs:255-258)."""
    return {rel_key(e): e for e in edge_types}


@dataclass(frozen=True)
class TypeIndex:
    """Dense integer enumeration of node and edge types.

    Built once at graph ingest; all device code addresses types by integer id.
    """

    node_types: Tuple[NodeType, ...]
    edge_types: Tuple[EdgeType, ...]

    @property
    def rel_keys(self) -> Tuple[RelType, ...]:
        return tuple(rel_key(e) for e in self.edge_types)

    def node_id(self, node_type: NodeType) -> int:
        return self.node_types.index(node_type)

    def rel_id(self, rel: RelType | EdgeType) -> int:
        if isinstance(rel, tuple):
            rel = rel_key(rel)
        return self.rel_keys.index(rel)

    def src_dst_ids(self, rel_id: int) -> Tuple[int, int]:
        src, _, dst = self.edge_types[rel_id]
        return self.node_id(src), self.node_id(dst)

    @staticmethod
    def build(node_types: Sequence[NodeType], edge_types: Sequence[EdgeType]) -> "TypeIndex":
        return TypeIndex(tuple(node_types), tuple(tuple(e) for e in edge_types))
