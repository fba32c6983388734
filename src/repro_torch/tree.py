"""The port's trees: nested dicts, lists and tuples with tensors (or other
values) at the leaves, as the model's parameters and the trainer's state
are.  The counterpart of the few `jax.tree` functions the trainer, the
optimizer and the checkpoints use.

Dicts are walked in sorted key order, as `jax.tree_util` walks them, so
two trees of one structure give their leaves in one order, and
`leaves_with_path` names each leaf as `jax.tree_util.keystr` would:
`['params']['layers'][0]['attn/wq']`.
"""

from __future__ import annotations

from typing import Any, Callable

Tree = Any
_END = object()


def _children(tree) -> list | None:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_path(tree: Tree, prefix: str = "") -> list:
    """[(keystr path, leaf)] in the tree's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, child in kids for item in leaves_with_path(child, f"{prefix}[{k!r}]")]


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like: Tree, values) -> Tree:
    """A tree of `like`'s structure with `values` at its leaves, in order."""
    it = iter(values)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(child) for k, child in kids}
        return type(node)(build(child) for _, child in kids)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of `tree` and of the trees of its structure in
    `rest`, leaf by leaf."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
