"""Newick trees: the node used by the tree builders and its printer, the
parser, patristic distances (the training targets) and the tree diameter
(the simulators' rescaling target).

Supported newick syntax: nested parens, leaf/internal labels, quoted labels
(``'...'`` with ``''`` escape), branch lengths (``:1.23e-4``), comments in
``[...]`` (skipped), trailing ``;``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Node:
    name: str = ""
    length: Optional[float] = None  # branch length to parent (None for root w/o bl)
    children: List["Node"] = field(default_factory=list)
    parent: Optional["Node"] = None

    # -- structure ----------------------------------------------------------
    @property
    def is_leaf(self) -> bool:
        return not self.children

    def add_child(self, child: "Node") -> "Node":
        child.parent = self
        self.children.append(child)
        return child

    def traverse_preorder(self) -> Iterator["Node"]:
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))

    def traverse_postorder(self) -> Iterator["Node"]:
        out: List[Node] = []
        stack = [self]
        while stack:
            node = stack.pop()
            out.append(node)
            stack.extend(node.children)
        return iter(reversed(out))

    def leaves(self) -> List["Node"]:
        return [n for n in self.traverse_preorder() if n.is_leaf]

    def leaf_names(self) -> List[str]:
        return [n.name for n in self.leaves()]

    # -- output -------------------------------------------------------------
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

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Node({self.to_newick()})"


def _quote_label(name: str) -> str:
    if name == "":
        return ""
    if any(c in name for c in "()[]{}:;,'\" \t\n"):
        return "'" + name.replace("'", "''") + "'"
    return name


class NewickError(ValueError):
    pass


def parse_newick(text: str) -> Node:
    """Parse one newick string into its root :class:`Node`."""
    pos = 0
    n = len(text)

    def skip_ws_and_comments(i: int) -> int:
        while i < n:
            c = text[i]
            if c.isspace():
                i += 1
            elif c == "[":
                j = text.find("]", i + 1)
                if j < 0:
                    raise NewickError("unterminated [comment]")
                i = j + 1
            else:
                break
        return i

    def parse_label(i: int) -> Tuple[str, int]:
        i = skip_ws_and_comments(i)
        if i < n and text[i] == "'":
            out = []
            i += 1
            while i < n:
                if text[i] == "'":
                    if i + 1 < n and text[i + 1] == "'":
                        out.append("'")
                        i += 2
                    else:
                        i += 1
                        break
                else:
                    out.append(text[i])
                    i += 1
            return "".join(out), i
        start = i
        while i < n and text[i] not in "(),:;[":
            i += 1
        return text[start:i].strip(), i

    def parse_clade(i: int) -> Tuple[Node, int]:
        i = skip_ws_and_comments(i)
        node = Node()
        if i < n and text[i] == "(":
            i += 1
            while True:
                child, i = parse_clade(i)
                node.add_child(child)
                i = skip_ws_and_comments(i)
                if i < n and text[i] == ",":
                    i += 1
                    continue
                if i < n and text[i] == ")":
                    i += 1
                    break
                raise NewickError(f"expected ',' or ')' at position {i}")
        label, i = parse_label(i)
        node.name = label
        i = skip_ws_and_comments(i)
        if i < n and text[i] == ":":
            i += 1
            i = skip_ws_and_comments(i)
            start = i
            while i < n and (text[i] in "+-.eE" or text[i].isdigit()):
                i += 1
            try:
                node.length = float(text[start:i])
            except ValueError as err:
                raise NewickError(f"bad branch length at position {start}") from err
        return node, i

    root, pos = parse_clade(pos)
    pos = skip_ws_and_comments(pos)
    if pos < n and text[pos] == ";":
        pos += 1
    pos = skip_ws_and_comments(pos)
    if pos != n:
        raise NewickError(f"trailing characters after tree at position {pos}")
    return root


def read_newick(path) -> Node:
    with open(path) as fh:
        return parse_newick(fh.read())


# ---------------------------------------------------------------------------
# Patristic distances
# ---------------------------------------------------------------------------

def patristic_matrix(root: Node, order: Optional[Sequence[str]] = None) -> Tuple[np.ndarray, List[str]]:
    """Full symmetric ``(n, n)`` patristic distance matrix.

    ``order`` selects/permutes the taxa (for training targets: the
    alignment's id order); default is tree leaf order.
    Distances are path sums of branch lengths (missing lengths count as 0).
    """
    leaves = root.leaves()
    names = [leaf.name for leaf in leaves]
    index = {name: i for i, name in enumerate(names)}
    if len(index) != len(names):
        raise NewickError("duplicate leaf names in tree")
    n = len(names)
    dist = np.zeros((n, n), dtype=np.float64)

    # Postorder sweep carrying (leaf indices, distances-to-current-node).
    carry: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for node in root.traverse_postorder():
        if node.is_leaf:
            carry[id(node)] = (
                np.array([index[node.name]], dtype=np.int64),
                np.zeros(1, dtype=np.float64),
            )
            continue
        parts = []
        for child in node.children:
            idxs, dists = carry.pop(id(child))
            parts.append((idxs, dists + (child.length or 0.0)))
        for a in range(len(parts)):
            ia, da = parts[a]
            for b in range(a + 1, len(parts)):
                ib, db = parts[b]
                dist[np.ix_(ia, ib)] = da[:, None] + db[None, :]
                dist[np.ix_(ib, ia)] = db[:, None] + da[None, :]
        carry[id(node)] = (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
        )

    if order is not None:
        try:
            perm = np.array([index[name] for name in order], dtype=np.int64)
        except KeyError as err:
            raise NewickError(f"taxon {err.args[0]!r} not found in tree") from err
        dist = dist[np.ix_(perm, perm)]
        names = list(order)
    return dist, names


def patristic_vector(root: Node, order: Sequence[str]) -> np.ndarray:
    """Upper-triangle patristic distance vector in ``combinations(order, 2)``
    order — the training target of one alignment."""
    mat, _ = patristic_matrix(root, order)
    iu = np.triu_indices(mat.shape[0], k=1)
    return mat[iu].astype(np.float32)


def load_distance_matrix(path, ids: Sequence[str]) -> np.ndarray:
    """The reference's target loader: a Newick file's float32 upper-triangle
    patristic vector in ``ids`` order."""
    return patristic_vector(read_newick(path), ids)


def tree_diameter(root: Node) -> float:
    """Largest leaf-to-leaf patristic distance (cf. the reference's
    double-BFS ``tree_diam`` in ``simulate_trees.py``)."""
    best = 0.0
    carry: Dict[int, float] = {}
    for node in root.traverse_postorder():
        if node.is_leaf:
            carry[id(node)] = 0.0
            continue
        depths = [carry.pop(id(c)) + (c.length or 0.0) for c in node.children]
        depths.sort(reverse=True)
        if len(depths) >= 2:
            best = max(best, depths[0] + depths[1])
        carry[id(node)] = depths[0] if depths else 0.0
    return best


def scale_branches(root: Node, factor: float) -> None:
    """Multiply every branch length of the tree by ``factor``, in place."""
    for node in root.traverse_preorder():
        if node.length is not None:
            node.length *= factor
