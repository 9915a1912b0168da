"""Tests that need the card (marker ``gpu``); they skip without a CUDA device.

This file imports torch and the port only, so it also runs where jax is
not installed: ``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
on the GPU host (``--noconftest`` skips ``tests/conftest.py``, which
imports jax).
"""
import importlib.util
import math
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke._import_port()
    return chip_smoke


@pytest.mark.gpu
def test_exit_confidence_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's kernel check under pytest: the CUDA kernels against
    their plain version at the path's shapes, a ragged vocab, the qwen3-4b
    exit head (bf16 also against the hi + lo model), exact ties (also
    across two blocks' runs) and the edges of each path of ``ops.plan``
    (one tile and one more column, V % 8 != 0 in bf16, the widest d, a d
    off the k chunk, N 1-8 and 13), two launches bitwise equal and each row
    of an N 8 bf16 launch bitwise its launch alone (conf atol 1e-5, max /
    lse 1e-4, pred exact)."""
    assert _chip_smoke().check_exit_confidence(verbose=False) <= 1e-4


@pytest.mark.gpu
def test_decode_attention_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's decode-kernel check under pytest: the CUDA kernels
    against their plain version at the decode path's shapes and S 4096 in
    bf16 and fp32, with ragged positions, unwritten slots, a ring (one
    straddling a split), window 8 and a row with no valid slot (atol = rtol
    = fp32 2e-5, bf16 2e-2), and each row of a B 8 launch bitwise against
    its launch alone."""
    assert _chip_smoke().check_decode_attention(verbose=False) <= 2e-2


@pytest.mark.gpu
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's RMSNorm check under pytest: the JAX kernel tests'
    sweep, the kernel benchmark's 1024 x 512, qwen3-4b's width, N 1 and 3
    at d 2560, the warp path's widest row (fp32 2048, bf16 2816) and one
    16-byte chunk above it, d 4096 and 8192 on the block path, a ragged
    width and the block path's widest row plus a chunk on the loop path,
    fp32 and bf16, each width also against the path ``ops.plan`` gives it;
    and the planner's blocks an SM against the occupancy calculator (atol
    = rtol = fp32 2e-5, bf16 2e-2)."""
    assert _chip_smoke().check_rmsnorm(verbose=False) <= 2e-2


@pytest.mark.gpu
def test_flash_attention_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's flash-attention check under pytest: the JAX kernel
    tests' sweep, the kernel benchmark's shape, windows with and without
    the causal mask, window 0 (zeros), a ragged S and qwen3-4b's heads,
    fp32 and bf16, and in bf16 at S 2048 / 2047 with a window and without
    the causal mask, also against the bf16-P model (atol = rtol = fp32
    2e-5, bf16 2e-2)."""
    assert _chip_smoke().check_flash_attention(verbose=False) <= 2e-2


@pytest.mark.gpu
def test_mlstm_chunk_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's mLSTM-chunk check under pytest: the JAX kernel
    tests' sweep, the kernel benchmark's shape, dh 128 and xlstm-1.3b's dh
    1024 at L 128, L 256, a ragged L 200 and L 512 at dh 64, and dh 72,
    fresh and with a state, fp32 and bf16, and two chunks chained at dh 64
    and dh 128 (C1, n1, m1 and bf16 h against the plain version at fp32
    2e-5 / bf16 8e-2 / chained 2e-4, against the plain version in float64
    for the fp32 L 512 chunk; fp32 h against the plain version in float64
    at the tolerance times its row's condition number, capped at 16); the
    check raises on any disagreement."""
    assert math.isfinite(_chip_smoke().check_mlstm_chunk(verbose=False))


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    """One train step of the anytime classifier (seed-0 params, batch 128
    from the trainer's first batch seed) on the card and on the CPU: loss,
    grad norm, params and both moments within 1e-5."""
    _chip_smoke()                # puts the checkout's src/ on the path
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import (AdamW, DifficultyDataset,
                                      make_train_step, warmup_cosine)
    from repro_torch.tree import tree_leaves
    cfg = get_config("anytime-classifier")
    b = DifficultyDataset(num_classes=10, seed=0).sample(128, seed=10_000)
    batch = {"inputs": b["inputs"], "labels": b["labels"]}
    out = {}
    for device in ("cpu", cuda_device):
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
        opt = AdamW(learning_rate=warmup_cosine(3e-3, 40, 700),
                    weight_decay=0.01)
        step = make_train_step(cfg, opt, exit_weights=(0.2, 0.3, 0.5))
        params, state, m = step(params, opt.init(params), batch)
        out[str(device)] = (m, [t.cpu() for tree in (params, state.mu,
                                                      state.nu)
                                for t in tree_leaves(tree)])
    (m_cpu, cpu), (m_gpu, gpu) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) <= 1e-5
    assert max(float((a - b).abs().max()) for a, b in zip(gpu, cpu)) <= 1e-5


@pytest.mark.gpu
def test_plain_executor_stages_match_on_card(cuda_device):
    """chip_smoke.py's executor-stage check under pytest, on seed-0
    params: each ``device-single`` stage ``torch.equal`` to the bucket-1
    ``device-batched`` stage (h, logits, conf), and the bucket-8 plain body
    against the fused exit stage (h and conf within 1e-5, pred exact)."""
    chip_smoke = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    params = init_params(get_config("anytime-classifier"),
                         torch.Generator().manual_seed(0),
                         device=cuda_device)
    assert chip_smoke.check_executor_stages(params, verbose=False) <= 1e-5


@pytest.mark.gpu
def test_traffic_leg_on_card_launches_exit_once_per_dispatch(cuda_device,
                                                             tmp_path):
    """A 40-request open-loop run on ``device-kernel`` on the wall clock
    (seed-0 params, 2x the capacity measured first, RTDeepIoT behind
    reject admission), traced: exit launches = dispatches = device
    windows, and the traced leg's checks (a trace a response, ordered
    spans, the time split, the exports read back, a valid Chrome
    document)."""
    _chip_smoke()                # puts the checkout's src/ on the path
    from repro_torch.configs import get_config
    from repro_torch.launch import traffic_replay
    from repro_torch.models import init_params
    from repro_torch.serving.traffic import SCENARIOS
    params = init_params(get_config("anytime-classifier"),
                         torch.Generator().manual_seed(0),
                         device=cuda_device)
    ctx = traffic_replay.card_context(params, n_runs=5)
    cap = traffic_replay.measure_capacity(ctx, 48)
    src = SCENARIOS["2x-overload"].source_args(capacity=cap["rate"],
                                               n_requests=40, seed=0)
    export, chrome = str(tmp_path / "obs.jsonl"), str(tmp_path / "c.json")
    svc, res, leg = traffic_replay.run_leg(
        ctx, "rtdeepiot", traffic_replay.RTDEEPIOT_ARGS, {"mode": "reject"},
        source_args=src, trace={"enabled": True, "export": export,
                                "chrome": chrome})
    assert svc.spec.clock == "wall" and leg["n"] == 40
    assert leg["exit_launches"] == leg["n_dispatches"]
    assert cap["exit_launches"] == cap["n_dispatches"] > 0
    traced = traffic_replay.check_traced(svc, res, export, chrome)
    assert all(traced["checks"].values()), traced
