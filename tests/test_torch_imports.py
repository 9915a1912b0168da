"""The port stands alone: no jax, nothing of the JAX package, the card by
default."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.launch.kernel, "
            "repro_torch.serving, repro_torch.interop; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_init_params_defaults_to_the_card():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    if torch.cuda.is_available():
        params = init_params(get_config("anytime-classifier"),
                             torch.Generator().manual_seed(0))
        assert params["exit_shared"]["w_out"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(get_config("anytime-classifier"),
                        torch.Generator().manual_seed(0))
