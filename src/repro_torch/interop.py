"""Bridge between the JAX package's pytrees and the port's: params and
decode caches.

``from_reference(cfg, ref_params, device)`` takes the params pytree of
``repro.models.init_params`` (or a trained checkpoint), with numpy arrays
(or anything ``numpy.asarray`` reads) as leaves, and returns the layout of
``repro_torch.models.init_params``.  The JAX package stacks a stage's
repeated layers on a leading period axis (its ``scan`` group, between the
``prefix`` and ``tail`` layers); the port keeps one flat list of layers per
stage, so the bridge unstacks that axis.  Both packages store weights
``(in, out)``, so every tensor is copied as it is, never transposed.  Each
leaf goes through fp32 numpy and is then cast to the config's dtype, which
is exact for bf16 and fp32.

``cache_from_reference`` / ``cache_to_reference`` carry a decode cache
(``repro.models.init_decode_cache``) across, so both packages can start a
step from the same cache: the JAX package stores k and v ``(B, S, KV, dh)``
in its stage structure, the port ``(B, KV, S, dh)`` in a flat list of
layers per stage.

``to_reference(cfg, params)`` is the inverse of ``from_reference``: the
JAX package's param tree, its scan groups stacked again, with numpy
leaves.  ``repro_torch.training.checkpoint`` writes and reads that tree in
the JAX package's checkpoint format.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import param_dtype
from repro_torch.models.model import check_ported, resolve_device, stage_layouts
from repro_torch.tree import tree_leaves, tree_map


def _stage_layers(stage: dict) -> list:
    """Prefix layers, then each scanned period's layers in order, then the
    tail layers — the stage's layers in execution order."""
    layers = list(stage["prefix"])
    scan = stage.get("scan")
    if scan is not None:
        n_periods = np.shape(tree_leaves(scan)[0])[0]
        for i in range(n_periods):
            layers.extend(tree_map(lambda x, i=i: np.asarray(x)[i], slot)
                          for slot in scan)
    layers.extend(stage["tail"])
    return layers


def _check_layer_counts(cfg, stages):
    got = [len(s) for s in stages]
    want = [len(lay.layers) for lay in stage_layouts(cfg)]
    if got != want:
        raise ValueError(f"{cfg.name}: reference has {got} layers per "
                         f"stage, the config has {want}")


def _to_tensor(device, dtype):
    def fn(x):
        # a C-ordered writable copy: the port may write caches in place
        return torch.from_numpy(np.array(x, dtype=np.float32, order="C")).to(
            device=device, dtype=dtype)
    return fn


def from_reference(cfg, ref_params, device="cuda"):
    """The port's params for ``cfg`` from the JAX package's ``ref_params``,
    on ``device`` (the card by default), in the config's dtype."""
    check_ported(cfg)
    device = resolve_device(device)
    stages = [_stage_layers(sp) for sp in ref_params["stages"]]
    _check_layer_counts(cfg, stages)
    return tree_map(_to_tensor(device, param_dtype(cfg)), {
        "embed": dict(ref_params["embed"]),
        "stages": stages,
        "exits": [{"ln": e["ln"]} for e in ref_params["exits"]],
        "exit_shared": {"w_out": ref_params["exit_shared"]["w_out"]},
    })


def cache_from_reference(cfg, ref_cache, device="cuda", dtype=None):
    """The port's decode cache from the JAX package's (one entry per stage,
    numpy leaves), on ``device``; k and v in ``dtype`` (default: the
    config's), ``slot_pos`` int32."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or param_dtype(cfg)
    stages = [_stage_layers(st) for st in ref_cache]
    _check_layer_counts(cfg, stages)
    kv = _to_tensor(device, dtype)
    return [[{"k": kv(np.swapaxes(np.asarray(c["k"], np.float32), 1, 2)),
              "v": kv(np.swapaxes(np.asarray(c["v"], np.float32), 1, 2)),
              "slot_pos": torch.from_numpy(np.array(
                  c["slot_pos"], dtype=np.int32)).to(device)}
             for c in layers] for layers in stages]


def _ref_groups(cfg, lay):
    """(prefix, n_scan, tail) layer counts of the JAX package's layout of a
    stage of dense layers (``repro.models.model.stage_layouts``): a scan
    group of whole periods once the stage holds at least two."""
    period = len(cfg.period)
    n = lay.end - lay.start
    n_scan = n // period
    if n_scan < 2:
        return n, 0, 0
    return 0, n_scan, n - n_scan * period


def _regroup(cfg, stages, stack):
    """The JAX package's stage structure from per-stage lists of layers:
    per stage ``{"prefix": [...], "scan": (slot, ...) or None, "tail":
    [...]}``, each scan slot's leaves stacked on a leading period axis by
    ``stack`` (a list of arrays -> one array)."""
    period = len(cfg.period)
    out = []
    for lay, layers in zip(stage_layouts(cfg), stages):
        n_prefix, n_scan, n_tail = _ref_groups(cfg, lay)
        scan = None
        if n_scan:
            body = layers[n_prefix:n_prefix + n_scan * period]
            scan = tuple(
                tree_map(lambda *xs: stack(list(xs)),
                         *(body[i * period + j] for i in range(n_scan)))
                for j in range(period))
        out.append({"prefix": layers[:n_prefix], "scan": scan,
                    "tail": layers[len(layers) - n_tail:]})
    return out


def reference_tree(cfg, params):
    """The JAX package's param tree (``repro.models.init_params``) with the
    port's tensors as leaves, scan groups stacked with ``torch.stack``.  A
    stage without a scan group has no ``"scan"`` key, as in the JAX
    package.  Any tree of the params' structure (gradients, moments) works
    as ``params``."""
    check_ported(cfg)
    stages = []
    for st in _regroup(cfg, params["stages"], torch.stack):
        if st["scan"] is None:
            del st["scan"]
        stages.append(st)
    return {"embed": dict(params["embed"]), "stages": stages,
            "exits": [{"ln": e["ln"]} for e in params["exits"]],
            "exit_shared": {"w_out": params["exit_shared"]["w_out"]}}


def as_numpy(t):
    """A tensor as a numpy array on the host; bf16 as fp32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_reference(cfg, params):
    """The JAX package's param tree from the port's params (the inverse of
    :func:`from_reference`), with numpy leaves: fp32 and other numpy
    dtypes as they are, bf16 as fp32 (exact; cast to the JAX params' dtype
    before use)."""
    return tree_map(as_numpy, reference_tree(cfg, params))


def cache_to_reference(cfg, cache):
    """The JAX package's decode-cache structure from the port's: per stage
    ``{"prefix", "scan", "tail"}`` with k and v ``(B, S, KV, dh)`` as fp32
    numpy (exact for bf16; cast to the JAX cache's dtype before use) and
    ``slot_pos`` int32."""
    def layer(c):
        return {"k": np.swapaxes(c["k"].float().cpu().numpy(), 1, 2),
                "v": np.swapaxes(c["v"].float().cpu().numpy(), 1, 2),
                "slot_pos": c["slot_pos"].cpu().numpy().astype(np.int32)}

    return _regroup(cfg, [[layer(c) for c in st] for st in cache], np.stack)
