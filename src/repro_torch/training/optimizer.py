"""Hand-rolled AdamW with decoupled weight decay, global-norm gradient
clipping, and the warmup-cosine learning-rate schedule
(``repro.training.optimizer``).

The arithmetic is the JAX package's, operation for operation: gradients
and moments are read in fp32, the moments are stored in ``state_dtype``
(fp32 or bf16), both bias corrections and the schedule are fp32.  The
state mirrors the params: nested dicts and lists of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32, on the params' device
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        sdt = getattr(torch, self.state_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=sdt, device=p.device)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns ``(updates, new_state)``; the caller adds the updates to
        the params in fp32 (:func:`repro_torch.training.loop.make_train_step`)."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.clip_norm is not None:
            gn = torch.sqrt(sum(torch.sum(torch.square(g))
                                for g in tree_leaves(grads)) + 1e-12)
            scale = torch.clamp(self.clip_norm / gn, max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        sdt = getattr(torch, self.state_dtype)
        mu = tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g).to(sdt),
                      state.mu, grads)
        nu = tree_map(lambda v, g: (b2 * v.float()
                                    + (1 - b2) * torch.square(g)).to(sdt),
                      state.nu, grads)
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        lr = self._lr(step)

        def upd(m, v, p):
            m = m.float()
            v = v.float()
            return -lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                          + self.weight_decay * p.float())

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``; fp32 on a step
    tensor, as the JAX schedule computes it."""
    def schedule(step):
        step = step.float()
        warm = peak_lr * step / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
