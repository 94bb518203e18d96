"""The port imports nothing of JAX, flax, orbax or the JAX package, and
no ``triton`` either: every kernel is CUDA C++.

A fresh interpreter imports every module of ``ganlab_tpu_torch`` and then
looks at ``sys.modules``; the package's sources and ``chip_smoke.py`` are
also checked by their import statements.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|orbax|triton|ganlab_tpu)(\.|$)")
IMPORT = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)

PROBE = """
import importlib, json, pkgutil, sys
import ganlab_tpu_torch
names = ["ganlab_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ganlab_tpu_torch.__path__,
                                          "ganlab_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_package_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"ganlab_tpu_torch.serve", "ganlab_tpu_torch.ops.kernels.adain",
            "ganlab_tpu_torch.ops.kernels.resample",
            "ganlab_tpu_torch.ops.kernels.mbstd",
            "ganlab_tpu_torch.train.steps", "ganlab_tpu_torch.train.loop",
            "ganlab_tpu_torch.train.checkpoint", "ganlab_tpu_torch.cli",
            "ganlab_tpu_torch.learners", "ganlab_tpu_torch.data.pipeline",
            "ganlab_tpu_torch.utils.logging"} <= set(res["imported"])
    bad = [m for m in res["modules"] if FORBIDDEN.match(m)]
    assert bad == [], bad


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    imports = IMPORT.findall(src)
    assert "ganlab_tpu_torch" in imports
    assert [m for m in imports if FORBIDDEN.match(m)] == []


def test_package_sources_import_no_jax_no_triton():
    """No import statement of a forbidden module anywhere in the package,
    also not inside a function (where the probe above would not see it)."""
    files = sorted((ROOT / "ganlab_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in IMPORT.findall(f.read_text()) if FORBIDDEN.match(m)]
    assert bad == [], bad
