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

Reading the msgpack checkpoint files of ``repro.training.checkpoint`` is
not ported yet (ROADMAP Queue A item 1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import param_dtype
from repro_torch.models.model import check_ported, resolve_device, stage_layouts


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _stage_layers(stage: dict) -> list:
    """Prefix layers, then each scanned period's layers in order, then the
    tail layers — the stage's layers in execution order."""
    layers = list(stage["prefix"])
    scan = stage.get("scan")
    if scan is not None:
        n_periods = np.shape(_first_leaf(scan))[0]
        for i in range(n_periods):
            layers.extend(_map(lambda x, i=i: np.asarray(x)[i], slot)
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
    return _map(_to_tensor(device, param_dtype(cfg)), {
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


def cache_to_reference(cfg, cache):
    """The JAX package's decode-cache structure from the port's: per stage
    ``{"prefix", "scan", "tail"}`` with k and v ``(B, S, KV, dh)`` as fp32
    numpy (exact for bf16; cast to the JAX cache's dtype before use) and
    ``slot_pos`` int32."""
    def layer(c):
        return {"k": np.swapaxes(c["k"].float().cpu().numpy(), 1, 2),
                "v": np.swapaxes(c["v"].float().cpu().numpy(), 1, 2),
                "slot_pos": c["slot_pos"].cpu().numpy().astype(np.int32)}

    out = []
    for lay, st in zip(stage_layouts(cfg), cache):
        layers = [layer(c) for c in st]
        n_prefix, n_scan, n_tail = _ref_groups(cfg, lay)
        period = len(cfg.period)
        scan = None
        if n_scan:
            body = layers[n_prefix:n_prefix + n_scan * period]
            scan = tuple(
                {k: np.stack([body[i * period + j][k]
                              for i in range(n_scan)]) for k in body[j]}
                for j in range(period))
        out.append({"prefix": layers[:n_prefix], "scan": scan,
                    "tail": layers[len(layers) - n_tail:]})
    return out
