"""The port imports nothing of JAX, flax or the JAX package.

A fresh interpreter imports every module of ``ganlab_tpu_torch`` and then
looks at ``sys.modules``; ``chip_smoke.py`` is checked by its source.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|ganlab_tpu)(\.|$)")

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
            "ganlab_tpu_torch.train.steps"} <= set(res["imported"])
    bad = [m for m in res["modules"] if FORBIDDEN.match(m)]
    assert bad == [], bad


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert "ganlab_tpu_torch" in imports
    assert [m for m in imports if FORBIDDEN.match(m)] == []
