"""The newick tree node used by the tree builders, and its printer."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Node:
    name: str = ""
    length: Optional[float] = None  # branch length to parent (None for root w/o bl)
    children: List["Node"] = field(default_factory=list)
    parent: Optional["Node"] = None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def add_child(self, child: "Node") -> "Node":
        child.parent = self
        self.children.append(child)
        return child

    def to_newick(self, include_lengths: bool = True, fmt: str = "%.12g") -> str:
        parts: List[str] = []
        self._write(parts, include_lengths, fmt)
        parts.append(";")
        return "".join(parts)

    def _write(self, parts: List[str], lengths: bool, fmt: str) -> None:
        if self.children:
            parts.append("(")
            for i, child in enumerate(self.children):
                if i:
                    parts.append(",")
                child._write(parts, lengths, fmt)
            parts.append(")")
        parts.append(_quote_label(self.name))
        if lengths and self.length is not None:
            parts.append(":" + (fmt % self.length))


def _quote_label(name: str) -> str:
    if name == "":
        return ""
    if any(c in name for c in "()[]{}:;,'\" \t\n"):
        return "'" + name.replace("'", "''") + "'"
    return name
