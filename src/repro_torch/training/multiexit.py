"""Train the anytime (multi-exit) classifier — paper §III-A analog
(``examples/train_multiexit.py``).

Trains the 3-stage anytime classifier with deep supervision on the
synthetic difficulty-varying dataset, temperature-calibrates each exit's
confidence on a validation split, evaluates per-stage accuracy, and writes
to ``--out`` (``artifacts/torch/`` by default, git-ignored):

  anytime_classifier.ckpt     params checkpoint, in the JAX package's
                              format (``repro_torch.training.checkpoint``)
  oracle_tables.npz           per-test-sample (confidence, correct) per
                              stage + stage accuracies

The recipe, seeds, calibration grid and table keys are the example's.

  PYTHONPATH=src python -m repro_torch.training.multiexit [--steps 400] \\
      [--device cuda] [--out DIR]

It runs on the card (``--device cuda``, the default) unless asked for the
CPU (``--device cpu``).
"""
from __future__ import annotations

import argparse
import os
import pathlib
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import forward, init_params, params_device
from repro_torch.training import (AdamW, DifficultyDataset, checkpoint,
                                  eval_exit_metrics, make_train_step,
                                  warmup_cosine)

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "torch"


class TrainResult(NamedTuple):
    params: dict
    stage_acc: np.ndarray          # (n_stages,) on the test split
    temperatures: list             # per stage
    confidence: np.ndarray         # (n_test, n_stages) calibrated
    correct: np.ndarray            # (n_test, n_stages) bool


def calibrate_temperature(cfg, params, val, stage: int, grid=None):
    """Post-hoc temperature scaling per exit (reliability of max-prob
    confidence — the paper's utility metric must be calibrated to be a
    probability of correctness)."""
    grid = np.geomspace(0.25, 4.0, 17) if grid is None else grid
    feats = torch.as_tensor(val["inputs"]["features"],
                            device=params_device(params))
    with torch.no_grad():
        out = forward(cfg, params, {"features": feats},
                      upto_stage=stage + 1).logits[stage]
    logits = out.cpu().numpy().astype(np.float64)
    labels = np.asarray(val["labels"])
    best_t, best_nll = 1.0, np.inf
    for t in grid:
        lg = logits / t
        lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) \
            + lg.max(-1)
        nll = float(np.mean(lse - lg[np.arange(len(labels)), labels]))
        if nll < best_nll:
            best_nll, best_t = nll, t
    return best_t


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n-test", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="continue from OUT/anytime_classifier.ckpt")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    ap.add_argument("--out", default=str(ART),
                    help="output directory (default: artifacts/torch)")
    args = ap.parse_args(argv)

    cfg = get_config("anytime-classifier")
    ds = DifficultyDataset(num_classes=cfg.vocab_size, seed=args.seed)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device=args.device)
    ckpt = os.path.join(args.out, "anytime_classifier.ckpt")
    if args.resume and os.path.exists(ckpt):
        params, meta = checkpoint.load(ckpt, params, cfg=cfg)
        print(f"resumed from {ckpt} ({meta.get('steps')} steps)")

    opt = AdamW(learning_rate=warmup_cosine(3e-3, 40, args.steps),
                weight_decay=0.01)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, exit_weights=(0.2, 0.3, 0.5))

    print(f"training {cfg.name}: {args.steps} steps, batch {args.batch}")
    t0 = time.time()
    for step in range(args.steps):
        batch = ds.sample(args.batch, seed=10_000 + step)
        params, opt_state, metrics = step_fn(
            params, opt_state,
            {"inputs": batch["inputs"], "labels": batch["labels"]})
        if step % 50 == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({time.time()-t0:.0f}s)")

    # --- calibration (validation split) --------------------------------
    val = ds.sample(1000, seed=777)
    temps = [float(calibrate_temperature(cfg, params, val, s))
             for s in range(cfg.num_stages)]
    print("calibration temperatures:", [round(t, 3) for t in temps])

    # --- oracle tables on the test split --------------------------------
    test = ds.sample(args.n_test, seed=999)
    # per-stage temperature applied via per-stage eval
    conf = np.zeros((args.n_test, cfg.num_stages), np.float32)
    correct = np.zeros((args.n_test, cfg.num_stages), bool)
    for s, t in enumerate(temps):
        m = eval_exit_metrics(cfg, params, test, temperature=t)
        conf[:, s] = m["confidence"][:, s]
        correct[:, s] = m["correct"][:, s]
    accs = correct.mean(0)
    print("per-stage accuracy:", np.round(accs, 4),
          " mean confidence:", np.round(conf.mean(0), 4))
    # calibration sanity: confidence should track accuracy
    for s in range(cfg.num_stages):
        print(f"  stage {s}: acc={accs[s]:.3f} conf={conf[:, s].mean():.3f} "
              f"gap={abs(accs[s] - conf[:, s].mean()):.3f}")

    os.makedirs(args.out, exist_ok=True)
    checkpoint.save(ckpt, params,
                    {"config": cfg.name, "steps": args.steps,
                     "temperatures": temps}, cfg=cfg)
    np.savez(os.path.join(args.out, "oracle_tables.npz"),
             confidence=conf, correct=correct,
             difficulty=test["difficulty"], labels=test["labels"],
             stage_acc=accs, temperatures=np.array(temps),
             features=test["inputs"]["features"])
    print("saved artifacts to", os.path.abspath(args.out))
    return TrainResult(params, accs, temps, conf, correct)


if __name__ == "__main__":
    accs = main().stage_acc
    if not accs[-1] > accs[0]:
        raise SystemExit(f"deeper stages must be more accurate: {accs}")
