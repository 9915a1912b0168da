"""Tests that need the card (marker ``gpu``); they skip without a CUDA device.

This file imports torch and the port only, so it also runs where jax is
not installed: ``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
on the GPU host (``--noconftest`` skips ``tests/conftest.py``, which
imports jax).
"""
import importlib.util
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m gpu` on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_exit_confidence_kernel_matches_plain_on_card(cuda_device):
    """chip_smoke.py's kernel check under pytest: the CUDA kernel against
    its plain version at the path's shapes, a ragged vocab, the qwen3-4b
    exit head and exact ties (conf atol 1e-5, max / lse 1e-4, pred exact)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke._import_port()
    assert chip_smoke.check_exit_confidence(verbose=False) <= 1e-4
