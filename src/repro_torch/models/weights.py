"""The weight bridge: the reference's parameter tree <-> the port's.

:func:`params_from_numpy` turns the reference ``Model.init`` tree, given
as numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's
side), into the port's parameter tree of torch tensors on ``device``.
The layout is the reference's, unchanged: the same dict keys, uniform
layer stacks with a leading L axis, projections ``(d_in, d_out)``.  So
the two packages compute the same function on the same weights.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects: they cross as their uint16 bit patterns
and are viewed as ``torch.bfloat16`` on this side, bit for bit.
:func:`params_to_numpy` is the way back (bf16 leaves as uint16 bits).
A tree the reference has already quantized (``{"q4_packed": uint8,
"q4_scales": f32}`` subtrees) crosses the same way, bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    return tree_map_with_path(lambda _path, leaf: fn(leaf), tree)


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree: Any,
                       path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` for every leaf; ``path`` is the tuple of dict
    keys and list indices from the root (``jax.tree_util``'s
    ``tree_map_with_path``, with plain keys)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree: Any) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in the order :func:`tree_map_with_path`
    visits them."""
    out: List[Tuple[Tuple, Any]] = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def _to_torch(arr: Any, device: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """Reference parameter tree (numpy leaves) -> port tree on ``device``."""
    return tree_map(lambda a: _to_torch(a, device), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(tree: Any) -> Any:
    """Port tree -> numpy leaves (bfloat16 leaves as their uint16 bits)."""
    return tree_map(_to_numpy, tree)


def params_to(tree: Any, device: Any) -> Any:
    """The tree with every tensor on ``device`` (no copy where it is)."""
    return tree_map(lambda t: t.to(device), tree)
