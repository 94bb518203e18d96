"""The port imports nothing of JAX, flax, orbax, grain, tensorflow or the
JAX package, and no ``triton`` either: every kernel is CUDA C++.

A fresh interpreter imports every module of ``ganlab_tpu_torch`` and then
looks at ``sys.modules``; the package's sources and ``chip_smoke.py`` are
also checked by their import statements. The streaming image source's
DataLoader workers are processes of their own: what each one has loaded
is read from its memory map.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^(jax|jaxlib|flax|orbax|grain|tensorflow|triton|ganlab_tpu)(\.|$)")
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
            "ganlab_tpu_torch.utils.logging", "ganlab_tpu_torch.data.native",
            "ganlab_tpu_torch.data.prepare",
            "ganlab_tpu_torch.data.stream_source",
            "ganlab_tpu_torch.eval.fid",
            "ganlab_tpu_torch.eval.inception"} <= set(res["imported"])
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


WORKER_PROBE = """
import json, os, sys
import numpy as np
from PIL import Image
from ganlab_tpu_torch.data.stream_source import StreamingImageFolderSource
d = sys.argv[1]
for i in range(4):
    Image.fromarray(np.full((12, 10, 3), 40 * i, np.uint8)).save(
        os.path.join(d, f"{i}.png"))
src = StreamingImageFolderSource(d, 8, num_workers=2)
src.batch(2, 8)
maps = {w.pid: open(f"/proc/{w.pid}/maps").read()
        for w in src._iter._workers}
src.close()
print(json.dumps(maps))
"""


def test_stream_workers_import_no_jax(tmp_path):
    """The spawned decode workers load torch and the port, and no library
    of JAX, grain or tensorflow."""
    out = subprocess.run([sys.executable, "-c", WORKER_PROBE, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    maps = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(maps) == 2
    for text in maps.values():
        assert "libtorch" in text
        loaded = {line.split()[-1] for line in text.splitlines()
                  if line.split()[-1].startswith("/")}
        bad = [p for p in loaded
               if re.search(r"/(jax|jaxlib|grain|tensorflow|flax)/", p)]
        assert bad == [], bad
