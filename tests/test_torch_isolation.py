"""The port stands alone: it imports neither JAX nor the JAX package, and
it never runs on the CPU when the card was asked for."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
CHIP_SMOKE = REPO / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_every_module_imports_without_jax_or_repro():
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for mod in {_modules()!r}:\n"
            "    importlib.import_module(mod)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.configs import get_config
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.serve import serve
    from repro_torch.launch.step import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import OptConfig

    cfg = get_config("gpt_100m", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_paged_pools(cfg, 4, 4, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        serve("gpt-100m", 1, 4, 2, smoke=True)        # cuda is the default
    with pytest.raises(RuntimeError, match="cuda"):
        train("gpt-100m", 1, smoke=True)              # here too
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(cfg, OptConfig())
