"""The ``.npz`` parameter-tree format, shared with the JAX package.

The port's copy of the ``.npz`` half of ``audioldm2_tpu/utils/checkpoint.py``:
a tree of dicts and lists of arrays flattens to ``"a/0/b"`` keys, a ``None``
leaf to a one-element ``"<key>#none"`` sentinel, so a file written by either
package loads in the other as an equal tree. The JAX package's other format,
orbax directories, needs orbax, a JAX library, and the port does not read or
write it.

:func:`convert_reference_checkpoint` is the one-time importer: a reference
``.pth`` -> parameter tree -> ``.npz``; ``build_model(params=load(path))``
serves it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        # the JAX package's sentinel (orbax rejects zero-size arrays)
        out[prefix[:-1] + "#none"] = np.zeros((1,), np.float32)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for key, value in flat.items():
        is_none = key.endswith("#none")
        if is_none:
            key = key[: -len("#none")]
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if is_none else value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def array_leaves(tree) -> List[np.ndarray]:
    """The array leaves of a tree (``None`` leaves left out)."""
    return [v for k, v in _flatten(tree).items() if not k.endswith("#none")]


def save_npz(path: str, params) -> None:
    np.savez(path, **_flatten(params))


def load_npz(path: str):
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def _require_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path!r}: the port reads and writes .npz parameter trees only; a directory "
            "is the JAX package's orbax format, which needs orbax (a JAX library) and "
            "which the port does not read")


def save(path: str, params) -> None:
    _require_npz(path)
    save_npz(path, params)


def load(path: str):
    _require_npz(path)
    return load_npz(path)


def convert_reference_checkpoint(pth_path: str, model_name: str, out_path: str) -> None:
    """One-time reference ``.pth`` -> ``.npz`` conversion, for the family
    ``model_name``'s default config."""
    from audioldm2_torch import config
    from audioldm2_torch.pipeline import load_checkpoint_params

    _require_npz(out_path)
    cfg = config.default_audioldm_config(model_name)
    save(out_path, load_checkpoint_params(pth_path, cfg))
