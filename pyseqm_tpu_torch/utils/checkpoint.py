"""Checkpoint and resume of driver state.

PyTorch counterpart of ``pyseqm_tpu/utils/checkpoint.py``.  Every driver
state (``MDState``, ``XLBOMDState``, ``NHState``, the warm L-BFGS's
``_WarmLBFGSState``) is a dataclass of tensors and Python numbers, so one
generic routine serves them all: walk the fields, save each leaf in a
plain ``.npz`` (``leaf_i``) beside a structure signature, the sorted field
paths (``__structure__``), and restore into a state of the same structure.

The Langevin driver draws its random force from a ``torch.Generator``
and its state carries no key, so a resume that must equal the
uninterrupted run also saves and restores the generator's state
(``generator=``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_LEAF = (torch.Tensor, int, float)


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a state in field order: the fields of nested
    dataclasses; tensors and numbers are leaves."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _leaves(getattr(tree, f.name), f"{path}.{f.name}")]
    if isinstance(tree, _LEAF):
        return [(path, tree)]
    raise ValueError(f"checkpoint structure: {type(tree).__name__} at "
                     f"{path!r} is neither a dataclass, a tensor nor a "
                     "number")


def _rebuild(tree: Any, values):
    """``tree`` with its leaves replaced, in field order, from the
    iterator ``values``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), values)
            for f in dataclasses.fields(tree)})
    return next(values)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _signature(leaves) -> List[str]:
    return sorted(p for p, _ in leaves)


def save_state(path: str, state: Any,
               generator: Optional[torch.Generator] = None):
    """Write ``state`` to ``path`` (.npz); with ``generator``, its state
    too.  Tensors are copied to the host."""
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _host(x) for i, (_, x) in enumerate(leaves)}
    arrays["__structure__"] = np.frombuffer(
        json.dumps(_signature(leaves)).encode(), dtype=np.uint8)
    if generator is not None:
        arrays["__generator__"] = generator.get_state().numpy()
    np.savez_compressed(path, **arrays)


def _restore(ref, arr: np.ndarray, i: int):
    shape = tuple(getattr(ref, "shape", ()))
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected "
                         f"{shape}")
    if torch.is_tensor(ref):
        return torch.tensor(arr, dtype=ref.dtype, device=ref.device)
    return type(ref)(arr.item())


def load_state(path: str, like: Any,
               generator: Optional[torch.Generator] = None) -> Any:
    """Restore a state saved by :func:`save_state`.

    ``like`` (e.g. a freshly initialized state of the same batch) gives the
    structure, each leaf's dtype and device; values come from the file.
    Raises ValueError when the structure or a leaf's shape differs.  With
    ``generator``, its state is restored from the file too."""
    leaves = _leaves(like)
    with np.load(path) as d:
        saved = json.loads(bytes(d["__structure__"]).decode())
        expected = _signature(leaves)
        if saved != expected:
            raise ValueError(f"checkpoint structure mismatch:\n"
                             f"  saved:    {saved}\n"
                             f"  expected: {expected}")
        out = [_restore(ref, d[f"leaf_{i}"], i)
               for i, (_, ref) in enumerate(leaves)]
        if generator is not None:
            if "__generator__" not in d.files:
                raise ValueError("the checkpoint holds no generator state")
            generator.set_state(torch.from_numpy(d["__generator__"].copy()))
    return _rebuild(like, iter(out))
