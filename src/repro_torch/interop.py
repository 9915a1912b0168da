"""Weight bridge: the JAX package's params → the port's params.

``from_reference(cfg, ref_params, device)`` takes the params pytree of
``repro.models.init_params`` (or a trained checkpoint), with numpy arrays
(or anything ``numpy.asarray`` reads) as leaves, and returns the layout of
``repro_torch.models.init_params``.  The JAX package stacks a stage's
repeated layers on a leading period axis (its ``scan`` group, between the
``prefix`` and ``tail`` layers); the port keeps one flat list of layers per
stage, so the bridge unstacks that axis.  Both packages store weights
``(in, out)``, so every tensor is copied as it is, never transposed.

Reading the msgpack checkpoint files of ``repro.training.checkpoint`` is
not ported yet (ROADMAP Queue A item 1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import check_ported, resolve_device, stage_layouts


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _stage_layers(stage: dict) -> list:
    """Prefix layers, then each scanned period's layers in order, then the
    tail layers — the stage's layers in execution order."""
    layers = list(stage["prefix"])
    scan = stage.get("scan")
    if scan is not None:
        n_periods = len(np.asarray(scan[0]["mixer"]["ln"]))
        for i in range(n_periods):
            layers.extend(_map(lambda x, i=i: np.asarray(x)[i], slot)
                          for slot in scan)
    layers.extend(stage["tail"])
    return layers


def from_reference(cfg, ref_params, device="cuda"):
    """The port's params for ``cfg`` from the JAX package's ``ref_params``,
    on ``device`` (the card by default)."""
    check_ported(cfg)
    device = resolve_device(device)

    def to_tensor(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    stages = [_stage_layers(sp) for sp in ref_params["stages"]]
    layouts = stage_layouts(cfg)
    got = [len(s) for s in stages]
    want = [len(lay.layers) for lay in layouts]
    if got != want:
        raise ValueError(f"{cfg.name}: reference params have {got} layers "
                         f"per stage, the config has {want}")
    return _map(to_tensor, {
        "embed": {"w_in": ref_params["embed"]["w_in"]},
        "stages": stages,
        "exits": [{"ln": e["ln"]} for e in ref_params["exits"]],
        "exit_shared": {"w_out": ref_params["exit_shared"]["w_out"]},
    })
