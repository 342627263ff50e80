"""Checkpointing: msgpack-serialized train states (a port of
``repro/train/checkpoint.py``; lease termination, paper §4.3).

The file layout is the reference's, so a checkpoint crosses between the
packages both ways: ``{b"treedef": ..., b"leaves": [{b"__nd__", b"dtype",
b"shape", b"data"}, ...]}`` with the leaves in
``jax.tree_util.tree_flatten`` order of the reference's tree — dict keys
sorted (``opt.mu``, ``opt.nu``, ``params``, ``step``), the port's
per-layer lists stacked back into ``[L, ...]`` leaves and hybrid
``groups`` into ``[G, every, ...]`` (``models/convert.py``). The
reference's restore reads only ``b"leaves"``; ``b"treedef"`` here names
the leaves' key paths. The write is atomic (tmp + rename), and ``restore``
checks the count and shapes of the leaves against the state it restores
into.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, List, Tuple

import msgpack
import numpy as np

from repro_torch.models.convert import (jax_layout, params_from_jax,
                                        state_to_jax)
from repro_torch.train.optimizer import leaves


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) in jax's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}.{k}" if path else k)
        return out
    return [(path, tree)]


def _pack_leaf(x):
    arr = np.asarray(x)
    return {b"__nd__": True, b"dtype": arr.dtype.str,
            b"shape": list(arr.shape), b"data": arr.tobytes()}


def _unpack_leaf(d) -> np.ndarray:
    arr = np.frombuffer(d[b"data"], dtype=np.dtype(d[b"dtype"]))
    return arr.reshape(d[b"shape"])


def save(path: str, state: dict) -> None:
    """Write the port's train state (``train/state.py``) in the reference's
    layout."""
    flat = _flatten(state_to_jax(state))
    payload = {
        b"treedef": ("keys(" + ", ".join(p for p, _ in flat) + ")").encode(),
        b"leaves": [_pack_leaf(l) for _, l in flat],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # atomic write: tmp + rename (a killed lease must never corrupt the ckpt)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(msgpack.packb(payload))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _shape_layout(state: dict) -> dict:
    """The reference layout of ``state`` with each leaf's shape."""
    def shapes(tree):
        return jax_layout(tree, lambda t: tuple(t.shape),
                          lambda xs: (len(xs),) + tuple(xs[0]))
    return {"params": shapes(state["params"]),
            "opt": {k: shapes(v) for k, v in state["opt"].items()},
            "step": ()}


def _unflatten(flat: List[Tuple[str, Any]]) -> dict:
    out: dict = {}
    for path, leaf in flat:
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def restore(path: str, like: dict) -> dict:
    """A new port train state with the structure of ``like`` (shapes
    validated), on the device of ``like``'s params."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    want = _flatten(_shape_layout(like))
    saved = [_unpack_leaf(d) for d in payload[b"leaves"]]
    if len(saved) != len(want):
        raise ValueError(f"checkpoint has {len(saved)} leaves, expected "
                         f"{len(want)}")
    for s, (p, shape) in zip(saved, want):
        if tuple(s.shape) != tuple(shape):
            raise ValueError(f"shape mismatch at {p}: {s.shape} vs {shape}")
    tree = _unflatten([(p, s) for s, (p, _) in zip(saved, want)])
    device = next(leaves(like["params"])).device
    params = params_from_jax(tree["params"], device)
    for p in leaves(params):
        p.requires_grad_(True)
    return {"params": params,
            "opt": {k: params_from_jax(v, device)
                    for k, v in tree["opt"].items()},
            "step": int(tree["step"])}


def exists(path: str) -> bool:
    return os.path.exists(path)
