"""Training loop: the deep-supervision multi-exit loss and the train step
(``repro.training.loop``).

The paper's anytime networks are trained so that every stage's exit head
gives both an intermediate classification and a confidence (§III-A).  Deep
supervision, a weighted sum of cross-entropies over all exits, is that
training signal; the confidence is the (calibrated) max-softmax of each
exit.

Ported: the ``features`` modality (the anytime classifier), on one device,
with gradients from ``torch.autograd``.  Text training and multi-token
prediction (ROADMAP Queue A item 12), the non-final exits' position stride
(item 12) and sharded training (item 10) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import forward, params_device
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _xent(logits, labels):
    """Mean cross-entropy. logits: (..., V); labels: (...) integer."""
    lg = logits.float()
    lse = torch.logsumexp(lg, -1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _exit_loss(cfg, logits, labels):
    if cfg.modality == "features":
        return _xent(logits, labels)                     # (B,V) vs (B,)
    raise NotImplementedError(
        f"the exit loss of modality {cfg.modality!r} is not ported to "
        "repro_torch yet (ROADMAP Queue A item 12)")


def _on_device(tree, device):
    """``tree``'s arrays (numpy or tensors) as tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(x, device=device), tree)


def make_loss_fn(cfg, *, exit_weights: Optional[tuple] = None, ctx=None,
                 aux_exit_stride: int = 1):
    """Returns ``loss_fn(params, batch) -> scalar``.

    batch = ``{"inputs": {"features": ...}, "labels": ...}``, numpy arrays
    or tensors; they are moved to the params' device.  ``exit_weights``
    (one per stage, default equal) are normalised to sum 1 in fp32."""
    if ctx is not None:
        raise NotImplementedError(
            "sharded training is not ported to repro_torch yet "
            "(ROADMAP Queue A item 10)")
    if aux_exit_stride != 1:
        raise NotImplementedError(
            "aux_exit_stride (strided supervision of the non-final exits of "
            "a text model) is not ported to repro_torch yet "
            "(ROADMAP Queue A item 12)")
    if cfg.mtp:
        raise NotImplementedError(
            "multi-token prediction is not ported to repro_torch yet "
            "(ROADMAP Queue A item 12)")

    def loss_fn(params, batch):
        device = params_device(params)
        out = forward(cfg, params, _on_device(batch["inputs"], device))
        labels = torch.as_tensor(batch["labels"], device=device)
        w = exit_weights or tuple(1.0 for _ in out.logits)
        w = torch.tensor(w, dtype=torch.float32, device=device)
        w = w / w.sum()
        total = torch.zeros((), dtype=torch.float32, device=device)
        for ws, lg in zip(w, out.logits):
            total = total + ws * _exit_loss(cfg, lg, labels)
        return total + out.aux

    return loss_fn


def make_train_step(cfg, optimizer, *, ctx=None, exit_weights=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the loss and its gradients by autograd, the
    optimizer's updates added to the params in fp32 and cast back to their
    dtype.  ``grad_norm`` is the global norm of the unclipped gradients.
    The params given are not modified; the step returns new tensors."""
    loss_fn = make_loss_fn(cfg, exit_weights=exit_weights, ctx=ctx)

    def train_step(params, opt_state, batch):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, live))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            params = tree_map(lambda p, u: (p.float() + u).to(p.dtype),
                              params, updates)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def eval_exit_metrics(cfg, params, dataset, *, batch_size: int = 64,
                      temperature: float = 1.0):
    """Per-sample records of every exit: the joint curves the scheduler
    consumes.

    dataset: dict with ``"inputs"`` (arrays with leading axis N) and
    ``"labels"``.  Returns ``{"correct": (N, n_stages) bool, "confidence":
    (N, n_stages) float32}``."""
    labels = np.asarray(dataset["labels"])
    N = labels.shape[0]
    n_stages = cfg.num_stages
    correct = np.zeros((N, n_stages), bool)
    confs = np.zeros((N, n_stages), np.float32)
    inputs = _on_device(dataset["inputs"], params_device(params))
    with torch.no_grad():
        for i in range(0, N, batch_size):
            sl = slice(i, min(N, i + batch_size))
            out = forward(cfg, params, tree_map(lambda x: x[sl], inputs),
                          conf_temperature=temperature)
            for s, (lg, cf) in enumerate(zip(out.logits, out.confidences)):
                pred = lg.argmax(-1).cpu().numpy()
                correct[sl, s] = pred == labels[sl]
                confs[sl, s] = cf.cpu().numpy()
    return {"correct": correct, "confidence": confs}
