"""npz checkpoints in the reference's format (``repro.training.
checkpoint``).

A checkpoint holds named trees (``{"params": ..., "opt": ...}``), each
leaf under the key ``<name>::<path>``, the path's parts joined by
``::`` as the reference prints jax's tree paths: a dict key as itself, a
list index as its number, and a field of the ``AdamWState`` NamedTuple
as jax's ``GetAttrKey`` prints it, ``.step`` / ``.m`` / ``.v`` (so
``params::layers::attn::w_q``, ``params::layers::tail::0::ln1::g``,
``opt::.m::embed``).  ``_step`` holds the step and ``_manifest`` a JSON
record of every leaf's shape and dtype name.  A bfloat16 leaf is written
as the reference's numpy writes an ``ml_dtypes.bfloat16`` array: raw
2-byte records (``|V2``), its dtype named ``bfloat16`` in the manifest,
and read back by that name.  So the port reads every file the reference
writes, and the reference reads the port's float32 files (its own
loader cannot cast the ``|V2`` records back: a caveat of the reference).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


_SEP = "::"


def _path_parts(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]``: dict keys in sorted order and list indices
    as jax flattens them, and the fields of a NamedTuple as
    ``GetAttrKey`` strings (``".m"``)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _path_parts(getattr(tree, f), prefix + (f".{f}",))
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _path_parts(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _path_parts(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _key(path: Tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: Any) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(path: str, step: int, trees: Dict[str, Any]) -> str:
    """trees: name -> tree (e.g. ``{"params": ..., "opt": ...}``).
    Returns the file's path (``.npz`` appended where missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload: Dict[str, np.ndarray] = {"_step": np.asarray(step)}
    manifest: Dict[str, Any] = {"step": step, "trees": {}}
    for name, tree in trees.items():
        flat = {_key(p): leaf for p, leaf in _path_parts(tree)}
        manifest["trees"][name] = {
            k: {"shape": list(v.shape),
                "dtype": (_dtype_name(v) if isinstance(v, torch.Tensor)
                          else str(np.asarray(v).dtype))}
            for k, v in flat.items()}
        for k, v in flat.items():
            payload[f"{name}{_SEP}{k}"] = _to_numpy(v)
    payload["_manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path, **payload)
    return path if path.endswith(".npz") else path + ".npz"


def load_checkpoint(path: str, templates: Dict[str, Any],
                    ) -> Tuple[int, Dict[str, Any]]:
    """Restore trees with the structure of ``templates`` (name -> tree of
    tensors): each leaf read by the manifest's dtype name and cast to
    the template leaf's dtype, on its device."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        step = int(data["_step"])
        manifest = json.loads(bytes(data["_manifest"]).decode())
        for name, template in templates.items():
            dtypes = manifest["trees"][name]

            def read(p, leaf, name=name, dtypes=dtypes):
                key = _key(p)
                t = _from_numpy(data[f"{name}{_SEP}{key}"],
                                dtypes[key]["dtype"])
                return t.to(dtype=leaf.dtype, device=leaf.device)

            out[name] = _map_with_parts(read, template)
    return step, out


def _map_with_parts(fn, tree: Any, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over ``tree`` with :func:`_path_parts`' paths,
    keeping its structure (NamedTuples included)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_parts(fn, getattr(tree, f),
                                            prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_with_parts(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_parts(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
