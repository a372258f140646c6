"""Checkpoints in the JAX package's `checkpoint.npz` format (counterpart of
the native-format half of neuman_tpu/trainers/checkpoint.py).

One `.npz` with '/'-joined pytree keys, list positions as integer parts.
The background stage writes {epoch, iteration, optim_state, coarse_model,
fine_model}: the nets in the JAX layout ({"w": [in, out], "b"} per layer,
`convert.to_jax_params`) and the Adam state as optax's chain state,
`optim_state/0/{0: count, 1: mu, 2: nu}`. So a background trained by
either package resumes in the other.
"""

import os
import re

import numpy as np
import torch


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_tree(tree, prefix=""):
    """Nested dict/list/tuple tree -> {'a/b/0/w': array} flat dict."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix.rstrip("/")] = _numpy(tree)
        return out
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat):
    """Inverse of flatten_tree. Integer path components become lists."""
    root = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(path, tree):
    """Write a tree checkpoint atomically."""
    flat = flatten_tree(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"  # .npz suffix so np.savez does not append one
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_checkpoint(path):
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_tree(flat)


def safe_merge_params(target, loaded):
    """Shape-tolerant merge: (merged, missing) with each leaf of `target`
    replaced by the same-path, same-shape leaf of `loaded` (a numpy array);
    `missing` lists the '/'-joined paths that kept the target's leaf."""
    missing = []

    def merge(t, l, path):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if isinstance(l, dict) and k in l:
                    out[k] = merge(v, l[k], path + (k,))
                else:
                    missing.append("/".join(map(str, path + (k,))))
                    out[k] = v
            return out
        if isinstance(t, (list, tuple)):
            out = []
            for i, v in enumerate(t):
                if isinstance(l, (list, tuple)) and i < len(l):
                    out.append(merge(v, l[i], path + (i,)))
                else:
                    missing.append("/".join(map(str, path + (i,))))
                    out.append(v)
            return out
        if l is not None and np.shape(l) == np.shape(t):
            return np.asarray(l)
        missing.append("/".join(map(str, path)))
        return t

    return merge(target, loaded, ()), missing
