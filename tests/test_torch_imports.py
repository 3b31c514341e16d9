"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``repro``."""

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
    assert "repro_torch.kernels.paged_attention" in mods
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert ROOT / "chip_smoke.py" in files and (ROOT / "chip_smoke.py").exists()
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []
