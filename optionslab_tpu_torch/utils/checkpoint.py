"""Pytree checkpoints for fitted state: model parameters, calibrated
``HestonParams``, optimizer states.

One backend, the JAX package's npz layout: ``leaves.npz`` holds leaf ``i``
under the key ``"i"`` and ``treedef.json`` a description of the structure. The
leaves are ordered as JAX orders them — dict entries by sorted key, a
dataclass by its fields, lists and tuples in order, ``None`` holding no
leaf — so a directory the JAX package wrote with its npz branch restores
here given a ``like`` tree of the same structure, and the other way round.
(``torch.utils._pytree`` orders a dict by insertion, hence the walk of its
own here.) The JAX package's orbax branch has no counterpart.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from .exceptions import ModelError


def _children(node):
    """(children, rebuild) of an inner node, or None for a leaf."""
    if node is None:
        return [], lambda kids: None
    if isinstance(node, dict):
        keys = sorted(node)
        return [node[k] for k in keys], lambda kids: dict(zip(keys, kids))
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return list(node), lambda kids: type(node)(*kids)
    if isinstance(node, (list, tuple)):
        return list(node), lambda kids: type(node)(kids)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return ([getattr(node, n) for n in names],
                lambda kids: dataclasses.replace(node, **dict(zip(names, kids))))
    return None


def _flatten(tree) -> list:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids[0] for leaf in _flatten(kid)]


def _unflatten(like, leaves):
    kids = _children(like)
    if kids is None:
        return next(leaves)
    return kids[1]([_unflatten(kid, leaves) for kid in kids[0]])


def _structure(tree):
    kids = _children(tree)
    if kids is None:
        return "*"
    return {"type": type(tree).__name__, "children": [_structure(k) for k in kids[0]]}


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(tree, path) -> str:
    """Persist a pytree of tensors, arrays and numbers; returns the backend
    used ("npz")."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = _flatten(tree)
    np.savez(path / "leaves.npz", **{str(i): _numpy(x) for i, x in enumerate(leaves)})
    (path / "treedef.json").write_text(json.dumps(_structure(tree)))
    return "npz"


def restore_pytree(path, like=None, device=None):
    """Restore a pytree saved by :func:`save_pytree` (or by the JAX
    package's npz branch) into the structure of ``like``.

    Each leaf comes back as a tensor on ``device`` (default: the device of
    the ``like`` leaf where that is a tensor, else the CPU), keeping the
    dtype it was saved with.
    """
    path = pathlib.Path(path)
    if not (path / "leaves.npz").exists():
        raise ModelError(f"{path} holds no leaves.npz: not an npz checkpoint")
    if like is None:
        raise ModelError("npz restore requires a `like` pytree for the structure")
    with np.load(path / "leaves.npz") as f:
        stored = [f[str(i)] for i in range(len(f.files))]
    like_leaves = _flatten(like)
    if len(stored) != len(like_leaves):
        raise ModelError(f"checkpoint holds {len(stored)} leaves, `like` has "
                         f"{len(like_leaves)}")
    out = [torch.as_tensor(a, device=device if device is not None else
                           (ref.device if isinstance(ref, torch.Tensor) else None))
           for a, ref in zip(stored, like_leaves)]
    return _unflatten(like, iter(out))
