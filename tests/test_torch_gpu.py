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
    """chip_smoke.py's kernel check under pytest: the CUDA kernel against
    its plain version at the path's shapes, a ragged vocab, the qwen3-4b
    exit head and exact ties (conf atol 1e-5, max / lse 1e-4, pred exact)."""
    assert _chip_smoke().check_exit_confidence(verbose=False) <= 1e-4


@pytest.mark.gpu
def test_decode_attention_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's decode-kernel check under pytest: the CUDA kernel
    against its plain version at the decode path's shapes in bf16 and fp32,
    with ragged positions, unwritten slots, a ring, window 8 and a row with
    no valid slot (atol = rtol = fp32 2e-5, bf16 2e-2)."""
    assert _chip_smoke().check_decode_attention(verbose=False) <= 2e-2


@pytest.mark.gpu
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's RMSNorm check under pytest: the JAX kernel tests'
    sweep, the kernel benchmark's 1024 x 512, qwen3-4b's width and widths
    that take the scalar path, fp32 and bf16 (atol = rtol = fp32 2e-5,
    bf16 2e-2)."""
    assert _chip_smoke().check_rmsnorm(verbose=False) <= 2e-2


@pytest.mark.gpu
def test_flash_attention_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's flash-attention check under pytest: the JAX kernel
    tests' sweep, the kernel benchmark's shape, windows with and without
    the causal mask, window 0 (zeros), a ragged S and qwen3-4b's heads,
    fp32 and bf16 (atol = rtol = fp32 2e-5, bf16 2e-2)."""
    assert _chip_smoke().check_flash_attention(verbose=False) <= 2e-2


@pytest.mark.gpu
def test_mlstm_chunk_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's mLSTM-chunk check under pytest: the JAX kernel
    tests' sweep and the kernel benchmark's shape, fresh and with a state,
    fp32 and bf16, and two chunks chained (C1, n1, m1 and bf16 h against
    the plain version at fp32 2e-5 / bf16 8e-2 / chained 2e-4; fp32 h
    against the plain version in float64 at the tolerance times its row's
    condition number, capped at 16); the check raises on any
    disagreement."""
    assert math.isfinite(_chip_smoke().check_mlstm_chunk(verbose=False))
