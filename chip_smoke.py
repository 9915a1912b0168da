"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — require a CUDA device; print its name, count, power limit and
             the fp32 matmul precision (TF32 is switched off);
2. build   — build the CUDA kernels from the sources in this checkout;
3. kernel  — hold each kernel against its plain PyTorch version on the card:
             the serving path's shapes, a ragged several-slab vocab, the
             qwen3-4b exit head and exact ties;
4. timing  — CUDA-event times of kernel and plain version beside the bound;
5. serve   — ``Service`` -> ``device-kernel`` on the anytime classifier at
             full width (random weights from seed 0), 120 requests from 8
             clients on the wall clock with two stacked device windows, with
             a check that every stage dispatch went through the exit kernel;
6. report  — one ``{"kernels": [...]}`` line, then the result line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parent / "src"

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores; the kernels here run fp32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

CONF_ATOL = 1e-5     # the JAX package's own kernel tests: conf 1e-5,
STAT_ATOL = 1e-4     # max_logit / lse 1e-4, pred exact

QWEN3_4B_HEAD = (8, 2560, 151936)   # rows, d_model, vocab of qwen3-4b


def _import_port():
    if not (SRC / "repro_torch").is_dir():
        raise RuntimeError(f"{SRC / 'repro_torch'} not found: run this script "
                           "from a checkout of the repository")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {name} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.splitlines()[0])
    print(f"[device] float32 matmul precision: "
          f"{torch.get_float32_matmul_precision()}, "
          f"matmul tf32 {torch.backends.cuda.matmul.allow_tf32}")
    return name


def phase_build() -> None:
    from repro_torch.kernels.exit_confidence import ops
    t0 = time.perf_counter()
    _lib, log = ops.load_library()
    print(f"[build] exit_confidence: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def _exit_inputs(n, d, v, seed, *, ties=()):
    """h (n, d), scale (d,), w_out (d, v) on the card, from ``seed``.

    ``ties``: column indices that get the same one-hot column e_0 of
    ``w_out`` with h[:, 0] raised, so they share the largest logit exactly
    (one nonzero product: every summation order gives the same value) and
    the first of them is the argmax."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g)
    scale = 0.1 * torch.randn(d, generator=g)
    w = 0.02 * torch.randn(d, v, generator=g)
    if ties:
        h[:, 0] = 4.0
        scale[0] = 0.0
        for c in ties:
            w[:, c] = 0.0
            w[0, c] = 1.0
    return h.cuda(), scale.cuda(), w.cuda()


def check_exit_confidence(verbose: bool = True) -> float:
    """Kernel against plain version at the path's shapes, a ragged vocab,
    the qwen3-4b head and exact ties.  Returns the largest abs error of
    conf / max_logit / lse; raises on any disagreement."""
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref
    cases = [(f"path N={n}", (n, 128, 10), {}) for n in (1, 2, 4, 8)]
    cases += [("ragged N=13 V=1000", (13, 128, 1000), {}),
              ("qwen3-4b head", QWEN3_4B_HEAD, {}),
              ("ties in slab + across", (13, 128, 1000),
               {"ties": (100, 200, 700)}),
              ("ties across slabs", (13, 128, 1000), {"ties": (300, 900)})]
    worst = 0.0
    for i, (label, (n, d, v), kw) in enumerate(cases):
        h, scale, w = _exit_inputs(n, d, v, seed=i, **kw)
        got = exit_confidence(h, scale, w)
        torch.cuda.synchronize()
        want = exit_confidence_ref(h, scale, w)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in
                zip((got[0], got[2], got[3]), (want[0], want[2], want[3]))]
        same_pred = bool(torch.equal(got[1], want[1]))
        if verbose:
            print(f"[kernel] exit_confidence {label} (N={n}, d={d}, V={v}): "
                  f"conf {errs[0]:.3e} max_logit {errs[1]:.3e} "
                  f"lse {errs[2]:.3e} pred {'equal' if same_pred else 'DIFFER'}")
        if kw.get("ties") and not bool((got[1] == kw["ties"][0]).all()):
            raise AssertionError(f"{label}: kernel argmax {got[1].tolist()} "
                                 f"is not the first tied column "
                                 f"{kw['ties'][0]}")
        if not same_pred or errs[0] > CONF_ATOL or errs[1] > STAT_ATOL \
                or errs[2] > STAT_ATOL:
            raise AssertionError(f"exit_confidence {label}: kernel disagrees "
                                 f"with the plain version: errors {errs}, "
                                 f"pred equal {same_pred}")
        worst = max(worst, *errs)
    return worst


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _exit_bound(n, d, v):
    """Least time for the function: each input read once and each output
    written once over HBM, or its 2 N d V fp32 FLOPs over the fp32 peak."""
    bytes_ = 4 * (n * d + d + d * v) + 4 * 4 * n
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * d * v / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_timing() -> dict:
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref
    out = {}
    for label, shape, iters in (("path", (8, 128, 10), 2000),
                                ("qwen3-4b head", QWEN3_4B_HEAD, 50)):
        h, scale, w = _exit_inputs(*shape, seed=100)
        plain = _time_ms(lambda: exit_confidence_ref(h, scale, w), iters)
        kernel = _time_ms(lambda: exit_confidence(h, scale, w), iters)
        kernel2 = _time_ms(lambda: exit_confidence(h, scale, w), iters)
        plain2 = _time_ms(lambda: exit_confidence_ref(h, scale, w), iters)
        bound, by = _exit_bound(*shape)
        out[label] = dict(shape=shape, ms=min(kernel, kernel2),
                          plain_ms=min(plain, plain2), bound_ms=bound,
                          bound_by=by)
        print(f"[timing] exit_confidence {label} N,d,V={shape}: kernel "
              f"{kernel:.5f}/{kernel2:.5f} ms, plain {plain:.5f}/{plain2:.5f} "
              f"ms, bound {bound:.6f} ms ({by})")
    return out


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    from repro_torch.launch.kernel import KernelStageFns
    from repro_torch.models import init_params, stage_forward
    from repro_torch.serving import (ServeSpec, Service, closed_loop_stream,
                                     profile_batched_stages,
                                     profile_host_overhead)
    from repro_torch.training import DifficultyDataset

    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    test = DifficultyDataset(num_classes=cfg.vocab_size,
                             seed=0).sample(600, seed=999)
    sample = {"features": test["inputs"]["features"][:1]}
    sfns = KernelStageFns(cfg, (1, 2, 4, 8))

    # each stage's fused output against the plain stage_forward, bucket 8
    h = sfns.pad(params, [{"features": test["inputs"]["features"][i:i + 1]}
                          for i in range(8)], 8)[0]
    hp = h
    for s in range(cfg.num_stages):
        h, pred, conf = sfns.call(s, params, h)
        hp, logits, conf_p = stage_forward(cfg, params, s, hp)
        torch.cuda.synchronize()
        if not (torch.isfinite(h).all() and torch.isfinite(conf).all()):
            raise AssertionError(f"stage {s}: non-finite output")
        h_err = float((h - hp).abs().max())
        err = float((conf - conf_p).abs().max())
        if h_err > CONF_ATOL or err > CONF_ATOL \
                or not torch.equal(pred.long(), logits.argmax(-1)):
            raise AssertionError(f"stage {s}: fused stage disagrees with "
                                 f"stage_forward (h err {h_err}, conf err "
                                 f"{err})")
        print(f"[serve] stage {s} fused vs plain: h err {h_err:.3e}, "
              f"pred equal, conf err {err:.3e}")

    tm, mat = profile_batched_stages(cfg, params, sfns, sample, n_runs=30)
    host_overhead = profile_host_overhead(device="cuda")
    print(f"[serve] stage WCETs (s) [stage x bucket 1,2,4,8]: "
          f"{np.array2string(mat, precision=6)}; host overhead "
          f"{host_overhead * 1e6:.1f} us")
    wcet = float(mat[:, 0].max())
    d_lo, d_hi = 4.0 * wcet, 14.0 * wcet
    stream = closed_loop_stream(test["inputs"], test["labels"], n_clients=8,
                                d_lo=d_lo, d_hi=d_hi, n_requests=120, seed=1)
    spec = ServeSpec(policy="rtdeepiot",
                     policy_args={"predictor": "exp",
                                  "prior_curve": [0.5, 0.7, 0.85]},
                     executor="device-kernel", clock="wall", source="stream",
                     host_overhead=host_overhead, pipeline_depth=3)
    svc = Service.from_spec(spec, cfg=cfg, params=params, time_model=tm,
                            stage_fns=sfns, labels=test["labels"])

    exit_confidence.launches = 0
    res = svc.run(stream)
    launches = exit_confidence.launches

    ex = svc.executor
    preds = [r.prediction for r in svc.responses if not r.missed]
    checks = {
        "120 responses": len(svc.responses) == 120,
        "hidden-state cache empty": ex.cache_stats()["live"] == 0,
        "two stacked windows": ex.max_inflight == 2,
        "some request served": len(preds) > 0,
        "every pred in [0, 10)": all(0 <= p < cfg.vocab_size for p in preds),
        "exit kernel launched once per dispatch":
            res.n_dispatches > 0 and launches == res.n_dispatches,
    }
    lat = float(np.mean([r.latency for r in svc.responses]))
    print(f"[serve] deadlines U[{d_lo * 1e3:.3f}, {d_hi * 1e3:.3f}] ms; "
          f"accuracy {res.accuracy:.4f} miss rate {res.miss_rate:.4f} "
          f"mean depth {res.mean_depth:.4f} mean latency {lat * 1e3:.4f} ms "
          f"dispatches {res.n_dispatches} exit-kernel launches {launches}")
    print(f"[serve] device_time_stats {json.dumps(ex.device_time_stats())}")
    print(f"[serve] cache_stats {ex.cache_stats()}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve phase failed: {failed}")
    return dict(launches=launches, n_dispatches=res.n_dispatches)


def main() -> int:
    name = phase_device()
    _import_port()
    phase_build()
    err = check_exit_confidence()
    timing = phase_timing()
    serve = phase_serve()
    path = timing["path"]
    kernels = [{
        "name": "exit_confidence", "route": "cuda",
        "source": "src/repro_torch/kernels/exit_confidence/exit_confidence.cu",
        "replaces": "src/repro/kernels/exit_confidence/kernel.py:67",
        "launches": serve["launches"], "max_abs_err": err,
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": None, "shape": list(path["shape"]),
        "qwen3_4b_head": {k: timing["qwen3-4b head"][k] for k in
                          ("shape", "ms", "plain_ms", "bound_ms",
                           "bound_by")},
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
