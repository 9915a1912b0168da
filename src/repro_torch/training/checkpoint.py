"""Checkpoints in the JAX package's file format
(``repro.training.checkpoint``), written and read both ways.

A file is the msgpack encoding (:mod:`repro_torch.training.msgpack_lite`)
of ``{"tree": {"leaves": [{"dtype", "shape", "data"}, ...], "treedef":
str}, "meta": {...}}``.  The leaves are the JAX package's param tree
(:func:`repro_torch.interop.reference_tree`: scan groups stacked on a
period axis) in ``jax.tree.flatten`` order — dict keys sorted, lists in
order — each as its dtype's name, its shape and its raw C-order bytes.
bf16 leaves are written and read as raw bf16 (``"bfloat16"``), through
``torch.frombuffer``, since numpy has no bf16 of its own.

The JAX package's ``load`` never reads ``"treedef"``; the port writes a
description of the tree's structure of its own there, and ignores the
field when it reads.

The port's params carry no config, and the JAX leaf order depends on the
config's scan layout, so ``save`` and ``load`` take the config as ``cfg``.
Writes are atomic: a temporary file in the same directory, then
``os.replace``.
"""
from __future__ import annotations

import math
import os
import tempfile

import torch

from repro_torch.interop import as_numpy, from_reference, reference_tree
from repro_torch.models.model import params_device
from repro_torch.training.msgpack_lite import packb, unpackb
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf, keys sorted."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _encode(tree):
    enc = []
    for leaf in tree_leaves(tree, sort_keys=True):
        t = leaf.detach().contiguous().cpu()
        enc.append({"dtype": str(t.dtype).removeprefix("torch."),
                    "shape": list(t.shape),
                    "data": t.reshape(-1).view(torch.uint8).numpy()
                    .tobytes()})
    return {"leaves": enc, "treedef": "repro_torch " + _describe(tree)}


def _decode(e) -> torch.Tensor:
    dtype = getattr(torch, e["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint leaf of unknown dtype {e['dtype']!r}")
    shape = tuple(e["shape"])
    if math.prod(shape) == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(e["data"]), dtype=dtype).reshape(shape)


def save(path: str, params, metadata: dict | None = None, *, cfg):
    """Write ``params`` (the port's, for ``cfg``) and ``metadata`` to
    ``path`` in the JAX package's format."""
    payload = {"tree": _encode(reference_tree(cfg, params)),
               "meta": metadata or {}}
    blob = packb(payload)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, like, *, cfg):
    """Restore into the structure of ``like`` (the port's params for
    ``cfg``; only its structure, shapes and device are read).  The leaf
    count and every shape are checked.  Returns ``(params, metadata)``,
    the params on ``like``'s device in ``cfg``'s dtype."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    enc = payload["tree"]["leaves"]
    skeleton = reference_tree(
        cfg, tree_map(lambda p: torch.empty(p.shape, device="meta"), like))
    refs = tree_leaves(skeleton, sort_keys=True)
    if len(enc) != len(refs):
        raise ValueError(f"checkpoint has {len(enc)} leaves, "
                         f"expected {len(refs)}")
    out = []
    for e, ref in zip(enc, refs):
        t = _decode(e)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs "
                             f"{tuple(ref.shape)}")
        out.append(as_numpy(t))
    tree = tree_unflatten(skeleton, out, sort_keys=True)
    return (from_reference(cfg, tree, device=params_device(like)),
            payload["meta"])
