"""In-memory B-tree used by meta partitions (inodeTree / dentryTree).

The paper stores inodes and dentries in two b-trees per meta partition
("employs two b-trees called inodeTree and dentryTree for fast lookup").
This is a classic order-``t`` B-tree keyed by arbitrary comparable tuples,
supporting point ops plus the range scans needed by readdir
(``dentryTree.range((parent, ""), (parent, MAX))``).
"""

from __future__ import annotations

import bisect
from typing import Any, Iterator, List, Optional, Tuple

__all__ = ["BTree"]

_T = 16  # minimum degree: nodes hold between _T-1 and 2*_T-1 keys


class _Node:
    __slots__ = ("keys", "values", "children")

    def __init__(self, leaf: bool = True):
        self.keys: List[Any] = []
        self.values: List[Any] = []
        self.children: List["_Node"] = [] if leaf else []

    @property
    def leaf(self) -> bool:
        return not self.children


class BTree:
    """Order-16 B-tree mapping comparable keys to values."""

    def __init__(self) -> None:
        self._root = _Node(leaf=True)
        self._len = 0

    def __len__(self) -> int:
        return self._len

    # ---- search ----------------------------------------------------------
    def get(self, key: Any, default: Any = None) -> Any:
        node = self._root
        while True:
            i = bisect.bisect_left(node.keys, key)
            if i < len(node.keys) and node.keys[i] == key:
                return node.values[i]
            if node.leaf:
                return default
            node = node.children[i]

    def __contains__(self, key: Any) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel

    # ---- insert ----------------------------------------------------------
    def put(self, key: Any, value: Any) -> None:
        root = self._root
        if len(root.keys) == 2 * _T - 1:
            new_root = _Node(leaf=False)
            new_root.children.append(root)
            self._split_child(new_root, 0)
            self._root = new_root
            root = new_root
        if self._insert_nonfull(root, key, value):
            self._len += 1

    def _split_child(self, parent: _Node, i: int) -> None:
        child = parent.children[i]
        mid = _T - 1
        right = _Node(leaf=child.leaf)
        right.keys = child.keys[mid + 1 :]
        right.values = child.values[mid + 1 :]
        if not child.leaf:
            right.children = child.children[mid + 1 :]
            child.children = child.children[: mid + 1]
        parent.keys.insert(i, child.keys[mid])
        parent.values.insert(i, child.values[mid])
        parent.children.insert(i + 1, right)
        child.keys = child.keys[:mid]
        child.values = child.values[:mid]

    def _insert_nonfull(self, node: _Node, key: Any, value: Any) -> bool:
        while True:
            i = bisect.bisect_left(node.keys, key)
            if i < len(node.keys) and node.keys[i] == key:
                node.values[i] = value  # overwrite
                return False
            if node.leaf:
                node.keys.insert(i, key)
                node.values.insert(i, value)
                return True
            child = node.children[i]
            if len(child.keys) == 2 * _T - 1:
                self._split_child(node, i)
                if node.keys[i] == key:
                    node.values[i] = value
                    return False
                if key > node.keys[i]:
                    i += 1
            node = node.children[i]

    # ---- delete ----------------------------------------------------------
    def delete(self, key: Any) -> bool:
        """Remove ``key``; returns True if it was present."""
        removed = self._delete(self._root, key)
        if not self._root.keys and self._root.children:
            self._root = self._root.children[0]
        if removed:
            self._len -= 1
        return removed

    def _delete(self, node: _Node, key: Any) -> bool:
        i = bisect.bisect_left(node.keys, key)
        if i < len(node.keys) and node.keys[i] == key:
            if node.leaf:
                node.keys.pop(i)
                node.values.pop(i)
                return True
            return self._delete_internal(node, i)
        if node.leaf:
            return False
        child = node.children[i]
        if len(child.keys) == _T - 1:
            self._fill(node, i)
            return self._delete(node, key)  # indices shifted; retry from node
        return self._delete(child, key)

    def _delete_internal(self, node: _Node, i: int) -> bool:
        key = node.keys[i]
        left, right = node.children[i], node.children[i + 1]
        if len(left.keys) >= _T:
            pk, pv = self._max_kv(left)
            node.keys[i], node.values[i] = pk, pv
            return self._delete(left, pk)
        if len(right.keys) >= _T:
            sk, sv = self._min_kv(right)
            node.keys[i], node.values[i] = sk, sv
            return self._delete(right, sk)
        self._merge(node, i)
        return self._delete(left, key)

    @staticmethod
    def _max_kv(node: _Node) -> Tuple[Any, Any]:
        while not node.leaf:
            node = node.children[-1]
        return node.keys[-1], node.values[-1]

    @staticmethod
    def _min_kv(node: _Node) -> Tuple[Any, Any]:
        while not node.leaf:
            node = node.children[0]
        return node.keys[0], node.values[0]

    def _fill(self, node: _Node, i: int) -> None:
        if i > 0 and len(node.children[i - 1].keys) >= _T:
            self._borrow_prev(node, i)
        elif i < len(node.children) - 1 and len(node.children[i + 1].keys) >= _T:
            self._borrow_next(node, i)
        elif i < len(node.children) - 1:
            self._merge(node, i)
        else:
            self._merge(node, i - 1)

    def _borrow_prev(self, node: _Node, i: int) -> None:
        child, sib = node.children[i], node.children[i - 1]
        child.keys.insert(0, node.keys[i - 1])
        child.values.insert(0, node.values[i - 1])
        node.keys[i - 1] = sib.keys.pop()
        node.values[i - 1] = sib.values.pop()
        if not sib.leaf:
            child.children.insert(0, sib.children.pop())

    def _borrow_next(self, node: _Node, i: int) -> None:
        child, sib = node.children[i], node.children[i + 1]
        child.keys.append(node.keys[i])
        child.values.append(node.values[i])
        node.keys[i] = sib.keys.pop(0)
        node.values[i] = sib.values.pop(0)
        if not sib.leaf:
            child.children.append(sib.children.pop(0))

    def _merge(self, node: _Node, i: int) -> None:
        child, sib = node.children[i], node.children[i + 1]
        child.keys.append(node.keys.pop(i))
        child.values.append(node.values.pop(i))
        child.keys.extend(sib.keys)
        child.values.extend(sib.values)
        if not child.leaf:
            child.children.extend(sib.children)
        node.children.pop(i + 1)

    # ---- iteration -------------------------------------------------------
    def items(self) -> Iterator[Tuple[Any, Any]]:
        yield from self._iter(self._root)

    def _iter(self, node: _Node) -> Iterator[Tuple[Any, Any]]:
        if node.leaf:
            yield from zip(node.keys, node.values)
            return
        for i, k in enumerate(node.keys):
            yield from self._iter(node.children[i])
            yield k, node.values[i]
        yield from self._iter(node.children[-1])

    def range(self, lo: Any, hi: Any) -> Iterator[Tuple[Any, Any]]:
        """Yield (k, v) with lo <= k < hi, in key order."""
        yield from self._range(self._root, lo, hi)

    def _range(self, node: _Node, lo: Any, hi: Any) -> Iterator[Tuple[Any, Any]]:
        i = bisect.bisect_left(node.keys, lo)
        if node.leaf:
            for j in range(i, len(node.keys)):
                if node.keys[j] >= hi:
                    return
                yield node.keys[j], node.values[j]
            return
        for j in range(i, len(node.keys)):
            yield from self._range(node.children[j], lo, hi)
            if node.keys[j] >= hi:
                return
            yield node.keys[j], node.values[j]
        yield from self._range(node.children[-1], lo, hi)

    def min_key(self) -> Optional[Any]:
        if not self._len:
            return None
        return self._min_kv(self._root)[0]

    def max_key(self) -> Optional[Any]:
        if not self._len:
            return None
        return self._max_kv(self._root)[0]
