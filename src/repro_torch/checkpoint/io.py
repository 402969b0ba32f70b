"""npz checkpoints of nested dicts and lists of tensors, with JSON
metadata (``repro/checkpoint/io.py``).

The port's "pytree" is a nested dict (and list) of tensors. It is
flattened as the reference flattens its trees: keys joined by ``/``,
a list index written ``[i]``, one npz entry a leaf, so each framework
reads the other's files. The DENSE server loop saves its full state
here every ``scfg.checkpoint_every`` epochs (``core/dense.py``), and
``launch/train.py --ckpt`` an LM's parameters.

A bfloat16 tensor is stored widened to float32, which is exact;
restoring casts every leaf back to the dtype of the tree it is restored
into. A reference file's bfloat16 arrays, which numpy stores as raw
2-byte records, are read back as their bits.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _seg(key) -> str:
    return f"[{key}]" if isinstance(key, int) else str(key)


def _items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, (*path, i))
    else:
        yield "/".join(_seg(p) for p in path), tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(_npz(path))


def save_checkpoint(path: str, tree, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz(path), **{k: _numpy(v) for k, v in _items(tree)})
    if meta is not None:
        with open(path.removesuffix(".npz") + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def _leaf_like(a: np.ndarray, like):
    """``a`` as a leaf of ``like``'s type, dtype and device."""
    if isinstance(like, torch.Tensor):
        if a.dtype.kind == "V" and a.dtype.itemsize == 2 \
                and like.dtype == torch.bfloat16:
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)
    return a.astype(np.asarray(like).dtype)


def _rebuild(tree, leaves, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaves, (*path, i)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return leaves["/".join(_seg(p) for p in path)]


def restore_checkpoint(path: str, like):
    """The checkpoint in the structure of ``like``: every leaf cast to
    the dtype of ``like``'s leaf, on its device (a numpy leaf of ``like``
    gives a numpy array). Raises ``ValueError`` when the checkpoint's
    keys are not exactly ``like``'s."""
    want = dict(_items(like))
    with np.load(_npz(path)) as f:
        if set(f.files) != set(want):
            raise ValueError(
                f"checkpoint keys mismatch vs `like` tree: "
                f"{sorted(set(f.files) ^ set(want))}")
        leaves = {k: _leaf_like(f[k], l) for k, l in want.items()}
    return _rebuild(like, leaves)


def load_tree(path: str, prefix: str = "") -> dict:
    """The entries of a checkpoint under ``prefix`` (``"gen_p"`` say) as a
    nested dict of numpy arrays, ``[i]`` segments as lists: a reference
    tree, which ``interop.load_ref`` copies into a module."""
    root: dict = {}
    with np.load(_npz(path)) as f:
        for key in f.files:
            segs = key.split("/")
            if prefix:
                if segs[0] != prefix:
                    continue
                segs = segs[1:]
            node = root
            for s in segs[:-1]:
                node = node.setdefault(s, {})
            node[segs[-1]] = f[key]
    if prefix and not root:
        raise ValueError(f"no entry under {prefix!r} in {_npz(path)}")
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.startswith("[") and k.endswith("]") for k in out):
        return [out[f"[{i}]"] for i in range(len(out))]
    return out


def load_meta(path: str) -> dict:
    with open(path.removesuffix(".npz") + ".json") as f:
        return json.load(f)
