"""Trees of tensors: flatten, unflatten and map, in the JAX package's
leaf order (the port keeps no dependency on `jax.tree`).

A node is a tuple or list (its items in order; a NamedTuple too), a dict
(its values in sorted key order, as `jax.tree` orders them) or a
dataclass instance (its fields in order, skipping those marked
`metadata=dict(static=True)`, as `jax.tree_util.register_dataclass` does);
None is an empty node; anything else is a leaf.  So a carried state
flattens here to the same leaves, in the same order, as its JAX twin.
"""

from __future__ import annotations

import dataclasses


def _children(node):
    """(kind, keys, children) of a node, or None for a leaf."""
    if node is None:
        return "none", (), ()
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return "namedtuple", node._fields, tuple(node)
    if isinstance(node, (tuple, list)):
        return type(node).__name__, tuple(range(len(node))), tuple(node)
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return "dict", keys, tuple(node[k] for k in keys)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        keys = tuple(f.name for f in dataclasses.fields(node)
                     if not f.metadata.get("static", False))
        return "dataclass", keys, tuple(getattr(node, k) for k in keys)
    return None


def flatten_with_path(tree, path=()):
    """[(path, leaf)] in leaf order; a path is the tuple of steps from the
    root, each as `jax.tree_util.keystr` writes it: `.field`, `['key']`,
    `[i]`."""
    node = _children(tree)
    if node is None:
        return [(path, tree)]
    name, keys, children = node
    out = []
    for key, child in zip(keys, children):
        step = (f"[{key!r}]" if name == "dict" else
                f".{key}" if name in ("namedtuple", "dataclass") else
                f"[{key}]")
        out.extend(flatten_with_path(child, path + (step,)))
    return out


def keystr(path) -> str:
    return "".join(path)


def flatten(tree):
    """(leaves, treedef): the leaves in order and what unflatten needs."""
    return [leaf for _, leaf in flatten_with_path(tree)], tree


_END = object()


def unflatten(treedef, leaves):
    """The tree `treedef` (a tree of the same structure, as `flatten`
    returns it) with its leaves replaced by `leaves`, in order."""
    it = iter(leaves)

    def build(node):
        kind = _children(node)
        if kind is None:
            return next(it)
        name, keys, children = kind
        new = [build(c) for c in children]
        if name == "none":
            return None
        if name == "namedtuple":
            return type(node)(*new)
        if name in ("tuple", "list"):
            return type(node)(new)
        if name == "dict":
            return type(node)(zip(keys, new))
        return dataclasses.replace(node, **dict(zip(keys, new)))

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`)."""
    leaves = [flatten(t)[0] for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def treedef_str(tree) -> str:
    """The tree's structure as text (leaves as *), for a checkpoint's
    record; nothing reads it back."""
    node = _children(tree)
    if node is None:
        return "*"
    name, keys, children = node
    if name == "none":
        return "None"
    label = type(tree).__name__ if name in ("namedtuple",
                                           "dataclass") else name
    inner = ", ".join(
        (f"{k}={treedef_str(c)}" if name != "tuple" and name != "list"
         else treedef_str(c)) for k, c in zip(keys, children))
    return f"{label}({inner})"
