"""Bit-exact checkpoint/resume of coupled simulations (port of
``io/checkpoint.py``).

Saves the whole integration state (spectral solution, the AB3 history
N_{-1}, N_{-2}, packets, clock, fields) so a resumed run continues the same
trajectory. The file is the reference's ``.npz``: ``leaf_<i>`` in JAX's
flatten order and ``__treepaths__``, the key path of every leaf (for a
``SimState``: ``.sol``, ``.clock.t``, ``.clock.step``,
``.stepper_state.N1``, ``.stepper_state.N2``, ``.packets.x`` ... ``.sign``,
``.fields``, then for a birth/death run ``.bd.age``, ``.bd.lifetime``,
``.bd.key`` (the PRNG key, uint32[2]) and ``.bd.births`` (int32); ``None``
is no leaf). So a checkpoint written by either package restores in the
other, the random stream included. ``Clock.step``, a host ``int`` here, is
stored as a 0-d int32 and restored as an ``int``.

Restore checks the stored paths, the leaf count and every leaf's shape
against the running state and raises ``ValueError`` on a mismatch, as the
reference does. The reference also writes ``__treedef__``, the ``repr`` of
JAX's tree structure, and falls back to it for files without
``__treepaths__``; this package can build neither, writes no
``__treedef__`` and refuses a file without ``__treepaths__``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def _flatten(tree, path: str = ""):
    """[(key path, leaf)] in JAX's flatten order: NamedTuple fields by
    attribute (``.name``), tuples and lists by index (``[i]``), dicts by
    sorted key (``['key']``); None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name in tree._fields
                for kv in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, sub in enumerate(tree) for kv in _flatten(sub, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [kv for key in sorted(tree) for kv in _flatten(tree[key], f"{path}[{key!r}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of new leaves."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, n), leaves) for n in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)   # the reference's Clock.step
    return np.asarray(leaf)


def save_checkpoint(path: str, state_tree) -> None:
    """Serialize a tree of tensors (NamedTuples, tuples, dicts) to one .npz."""
    flat = _flatten(state_tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    arrays["__treepaths__"] = np.frombuffer(
        "\n".join(p for p, _ in flat).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _restored(arr: np.ndarray, ref):
    """``arr`` as a leaf like ``ref``: on its device in its dtype."""
    if isinstance(ref, torch.Tensor):
        np_dtype = torch.empty((), dtype=ref.dtype).numpy().dtype
        return torch.as_tensor(arr.astype(np_dtype), device=ref.device)
    if isinstance(ref, int) and not isinstance(ref, bool):
        return int(arr)
    return arr.astype(np.result_type(ref))


def load_checkpoint(path: str, like_tree):
    """Restore into the structure of ``like_tree``, after checking (a) the
    stored key paths against ``like_tree``'s, (b) the leaf count and (c)
    every leaf's shape; a mismatch raises ValueError."""
    flat = _flatten(like_tree)
    with np.load(path) as data:
        if "__treepaths__" not in data:
            raise ValueError(
                f"checkpoint {path} has no __treepaths__ record, so its structure "
                "cannot be checked against the running state")
        stored = bytes(data["__treepaths__"]).decode()
        current = "\n".join(p for p, _ in flat)
        if stored != current:
            raise ValueError(
                "checkpoint pytree structure does not match the running "
                f"state:\n  stored:   {stored}\n  expected: {current}\n"
                "(was the checkpoint written with a different driver "
                "configuration — stepper, birth/death, packet layout?)"
            )
        n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_stored != len(flat):
            raise ValueError(
                f"checkpoint has {n_stored} leaves, running state has {len(flat)}")
        out = []
        for i, (_, ref) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            ref_shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
            if tuple(arr.shape) != tuple(ref_shape):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != expected {tuple(ref_shape)}")
            out.append(_restored(arr, ref))
    return _unflatten(like_tree, iter(out))
