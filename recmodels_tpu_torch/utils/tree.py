"""Parameter trees (dicts, lists and tensors) in the JAX package's flatten
order: dict keys sorted, lists in order."""

from __future__ import annotations

from typing import Iterator


def leaves(tree) -> Iterator:
    """Leaves in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def unflatten(template, new_leaves: Iterator):
    """A tree shaped like ``template`` whose leaves come from ``new_leaves``
    in flatten order."""
    if isinstance(template, dict):
        return {k: unflatten(template[k], new_leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [unflatten(v, new_leaves) for v in template]
    return next(new_leaves)

