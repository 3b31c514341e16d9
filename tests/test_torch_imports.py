"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's tools (``tools/*.py``) import neither JAX nor anything of the
reference package ``repro``."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    mods = list(port_modules())
    for mod in ("kernels.paged_attention", "kernels.rwkv6_scan",
                "kernels.mamba2_ssd", "models.rwkv6", "models.mamba2",
                "models.moe", "models.whisper", "models.paligemma",
                "serve.kvpage", "serve.prefix", "serve.engine",
                "memory.shared", "obs.recorder", "serve.fleet",
                "serve.fleet.board", "serve.fleet.worker",
                "serve.fleet.frontend"):
        assert f"repro_torch.{mod}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_jax_or_reference_import_lines():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)"
                         r"|from repro\.|from repro import)", re.M)
    tools = sorted((ROOT / "tools").glob("*.py"))    # the port's own tools
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + tools
    assert ROOT / "chip_smoke.py" in files and (ROOT / "chip_smoke.py").exists()
    assert {f.name for f in tools} >= {"flash_variants.py", "paged_variants.py"}
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []


def test_registry_has_the_recurrent_families_and_names_the_rest():
    """``rwkv``, ``hybrid``, ``moe``, ``encdec`` and ``vlm`` resolve to
    their modules, with no JAX and nothing of the reference loaded."""
    code = (
        "import json, sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.registry import get_model\n"
        "fams = {}\n"
        "for arch in ('rwkv6-3b', 'zamba2-2.7b', 'qwen2-moe-a2.7b',\n"
        "             'whisper-tiny', 'paligemma-3b'):\n"
        "    fams[arch] = get_model(get_config(arch)).forward.__module__\n"
        "fams['loaded'] = sorted(n for n in sys.modules\n"
        "                        if n.split('.')[0] in ('jax', 'repro'))\n"
        "print(json.dumps(fams))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    fams = json.loads(out.stdout.strip().splitlines()[-1])
    assert fams["rwkv6-3b"] == "repro_torch.models.rwkv6"
    assert fams["zamba2-2.7b"] == "repro_torch.models.mamba2"
    assert fams["qwen2-moe-a2.7b"] == "repro_torch.models.moe"
    assert fams["whisper-tiny"] == "repro_torch.models.whisper"
    assert fams["paligemma-3b"] == "repro_torch.models.paligemma"
    assert fams["loaded"] == []
