"""Checkpoint / resume of solver carries (PyTorch port of
yasph2d_tpu/utils/checkpoint.py, the same .npz layout).

A carry (nested NamedTuples) round-trips to one .npz file, each leaf stored
under its field path ("ctx/pos_pad", "time/dt", ...), so the file reads with
numpy alone and survives a field reorder. None fields have no leaf, as in the
JAX package's tree flattening. Besides its tensors, a port carry holds host
scalars that are state, not configuration: the warm-start iteration counts
(`prev_*_iterations`, Python ints) and the clock (`TimeState`, numpy
scalars); both are saved, as 0-d arrays.

The padded carries (DFSPHPaddedCarry, WCSPHPaddedCarry), the table carries
(DFSPHCarry with its neighbour tables, WCSPHCarry) and the sorted carries
(DFSPHDenseCarry with its slot grid, WCSPHDenseCarry) have the JAX leaf
paths and dtypes, so a checkpoint of the JAX package's carry loads into the
port and the reverse (the JAX slot-major route's carry also holds its TPU
band geometry, `ctx/sm/...`, which the port neither writes nor reads). The plane carries round-trip within the port: the JAX `PlaneCtx`
holds TPU geometry. A bfloat16 tensor (K1's bf16 geometry) is stored as its
int16 bits.
"""

import numpy as np
import torch


def _is_node(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves(tree, prefix=""):
    """[(path, leaf)] of a nested NamedTuple in field order; None fields
    have no leaf."""
    if tree is None:
        return []
    if _is_node(tree):
        out = []
        for name in tree._fields:
            out.extend(_leaves(getattr(tree, name), f"{prefix}{name}/"))
        return out
    return [(prefix[:-1], tree)]


def _rebuild(tree, values, prefix=""):
    """`tree` with each leaf replaced by values[path]."""
    if tree is None:
        return None
    if _is_node(tree):
        return type(tree)(*(_rebuild(getattr(tree, name), values, f"{prefix}{name}/")
                            for name in tree._fields))
    return values[prefix[:-1]]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(stored: np.ndarray, leaf):
    """`stored` as the template leaf's type, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.array(stored))
        t = t.view(torch.bfloat16) if leaf.dtype == torch.bfloat16 else t.to(leaf.dtype)
        return t.to(leaf.device)
    return type(leaf)(stored[()])  # a numpy scalar, or a Python int, float or bool


def save_checkpoint(path: str, carry) -> None:
    """Write a solver carry to `path` (.npz)."""
    leaves = _leaves(carry)
    arrays = {name: _to_numpy(leaf) for name, leaf in leaves}
    assert len(arrays) == len(leaves), "duplicate leaf paths"
    np.savez(path, **arrays)


def load_checkpoint(path: str, template):
    """Read a checkpoint into the structure of `template` (a carry with the
    same shapes, e.g. fresh from `solver.init_carry`): each leaf takes the
    template's type, dtype and device. Raises KeyError for a missing leaf and
    ValueError for a shape mismatch."""
    leaves = _leaves(template)
    values = {}
    with np.load(path) as data:
        missing = [name for name, _ in leaves if name not in data]
        if missing:
            raise KeyError(f"checkpoint {path} is missing leaves: {missing}")
        for name, leaf in leaves:
            stored = data[name]
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if stored.shape != shape:
                raise ValueError(f"shape mismatch for {name}: checkpoint {stored.shape} "
                                 f"vs template {shape}")
            values[name] = _from_numpy(stored, leaf)
    return _rebuild(template, values)
