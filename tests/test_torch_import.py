"""The port stands alone: every ``repro_torch`` module imports with
``jax`` and ``repro`` blocked, and neither the package nor
``chip_smoke.py`` names them in an import."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    mods = list(_modules())
    for m in ("repro_torch.kernels.isla_moments",
              "repro_torch.kernels.flash_attention", "repro_torch.configs",
              "repro_torch.models.attention", "repro_torch.models.model",
              "repro_torch.models.frontends",
              "repro_torch.serve.engine", "repro_torch.launch.serve",
              "repro_torch.launch.mesh", "repro_torch.sharding.specs",
              "repro_torch.models.moe", "repro_torch.sharding.context",
              "repro_torch.models.mamba2", "repro_torch.train",
              "repro_torch.train.checkpoint", "repro_torch.train.compression",
              "repro_torch.train.data", "repro_torch.train.elastic",
              "repro_torch.train.optimizer", "repro_torch.train.train_step",
              "repro_torch.core.tree", "repro_torch.launch.train",
              "repro_torch.launch.specs_io", "repro_torch.launch.dryrun",
              "repro_torch.roofline.analysis",
              "repro_torch.roofline.op_cost"):
        assert m in mods, m
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.models.model import (train_loss, "
            "abstract_params, MOE_LB_COEF, MOE_Z_COEF)\n"
            "from repro_torch.models.layers import chunked_ce_loss\n"
            "from repro_torch.models.attention import (attention_train, "
            "_blocked_attention, BLOCKED_THRESHOLD)\n"
            "from repro_torch.models.transformer import (grad_boundary, "
            "_train_group_body, forward_train)\n"
            "from repro_torch.models.mamba2 import apply_mamba_train\n"
            "from repro_torch.convert import opt_state_from\n"
            "from repro_torch.models.model import abstract_cache\n"
            "from repro_torch.launch.train import run, build_step\n"
            "from repro_torch.launch.specs_io import input_specs\n"
            "from repro_torch.launch.dryrun import lower_cell, run_cell\n"
            "from repro_torch.roofline.analysis import analyze_cost\n"
            "from repro_torch.roofline.op_cost import CostCounter\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() "
            "if v is not None]\n"
            f"print('ok', {len(mods)})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


IMPORT_RE = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)",
                       re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_reference_imports(path):
    text = (ROOT / path).read_text()
    assert not IMPORT_RE.search(text), path
