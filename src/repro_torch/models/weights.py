"""The weight bridge: the reference's parameter tree <-> the port's.

:func:`params_from_numpy` turns the reference ``Model.init`` tree, given
as numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's
side), into the port's parameter tree of torch tensors on ``device``.
The layout is the reference's, unchanged: the same dict keys, uniform
layer stacks with a leading L axis, projections ``(d_in, d_out)``, MoE
expert stacks (L, E, d, f) / (L, E, f, d) beside a float32 router
(L, d, E), and the SSD block's float32 A_log, D and dt_bias.  So the
two packages compute the same function on the same weights.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects: they cross as their uint16 bit patterns
and are viewed as ``torch.bfloat16`` on this side, bit for bit.
:func:`params_to_numpy` is the way back (bf16 leaves as uint16 bits).
A tree the reference has already quantized (``{"q4_packed": uint8,
"q4_scales": f32}`` subtrees) crosses the same way, bit for bit.

:func:`save_params_npz` / :func:`load_params_npz` carry a tree through
an ``.npz`` file, one array per leaf named by its path: how the serve
CLI and the engine worker (``--params``, through
:func:`load_params_like`, which checks the file against the model's own
tree) serve weights that were drawn elsewhere, such as the reference's
``Model.init(PRNGKey(0))``.
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


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in :func:`tree_leaves_with_path`'s order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


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


#: npz key syntax: path parts joined by "/", a list index written "#i",
#: and a bfloat16 leaf (stored as its uint16 bits) marked by this suffix
_BF16_SUFFIX = "@bfloat16"


def _npz_key(path: Tuple) -> str:
    parts = []
    for p in path:
        if isinstance(p, int):
            parts.append(f"#{p}")
        elif not isinstance(p, str) or "/" in p or p.startswith("#") \
                or "@" in p:
            raise ValueError(f"parameter path part {p!r} has no npz name")
        else:
            parts.append(p)
    return "/".join(parts)


def save_params_npz(tree: Any, path: str) -> None:
    """Write a parameter tree (numpy leaves, as the reference's tree
    after ``np.asarray``, or torch tensors) to ``path`` as an ``.npz``,
    one array per leaf; bfloat16 leaves as their uint16 bits, with the
    dtype recorded in the name.  A dict or list without leaves (an empty
    tail of layers) is not stored: no model reads one."""
    arrays = {}
    for p, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            bf16 = leaf.dtype == torch.bfloat16
            arr = _to_numpy(leaf)
        else:
            arr = np.asarray(leaf)
            bf16 = arr.dtype.name == "bfloat16"
            if bf16:
                arr = np.array(arr).view(np.uint16)
        arrays[_npz_key(p) + (_BF16_SUFFIX if bf16 else "")] = arr
    np.savez(path, **arrays)


def _listify(node: Any) -> Any:
    """Dicts keyed by list indices (``#i``) back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(k.startswith("#") for k in node):
        idx = sorted(int(k[1:]) for k in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"list indices {idx} are not 0..{len(idx) - 1}")
        return [_listify(node[f"#{i}"]) for i in idx]
    return {k: _listify(v) for k, v in node.items()}


def load_params_npz(path: str, device: Any = "cuda") -> Any:
    """The tree :func:`save_params_npz` wrote, as torch tensors on
    ``device`` (bfloat16 leaves viewed back from their bits)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            name, bf16 = key, key.endswith(_BF16_SUFFIX)
            if bf16:
                name = key[:-len(_BF16_SUFFIX)]
            arr = data[key]
            t = torch.from_numpy(np.array(arr))
            if bf16:
                t = t.view(torch.int16).view(torch.bfloat16)
            *parents, leaf = name.split("/")
            node = root
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = t.to(device)
    return _listify(root)


def load_params_like(path: str, like: Any, device: Any = "cuda") -> Any:
    """:func:`load_params_npz`, checked against the leaf paths and shapes
    of the tree ``like`` (the model's own ``init``); raises ValueError
    naming up to three leaves that differ."""
    want = {p: tuple(t.shape) for p, t in tree_leaves_with_path(like)}
    params = load_params_npz(path, device)
    got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(params)}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()), key=str)[:3]
        raise ValueError(f"leaves that differ, as (path, shape): {bad}")
    return params
