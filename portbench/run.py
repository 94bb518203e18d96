"""The benchmark of ganlab_tpu_torch on NVIDIA GPUs: one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. ``BENCHMARK.json`` names the cell; the
cell names a configuration (``portbench/configs/<name>.json``) and a
traffic mix (``portbench/traffic/<name>.json``, whose ``driver`` names the
module under ``portbench/drivers/`` that runs it); the limits of the
numbers that decide ``correct`` are ``portbench/limits/<cell>.json``;
each per-layer metric is read by ``portbench/metrics/<name>.py``; the
hand-written kernels' names and passes are ``portbench/kernels/*.json``.
A cell, a configuration, a mix, a metric or a kernel's names are added as
files and entries, with no edit to this file.

Set-up (``setup_s``) runs from the start of this script to the window's
first call: imports, the kernels' build (the first run in a checkout),
weights and data made on the device from ``--seed``, the traffic
driver's warm-up of every shape the window uses. Then the window runs for about
``--seconds``; with ``--trace 1`` under ``torch.profiler``, whose trace
the per-layer readers take. Then the program's state is freed and the
outputs the window produced are held to the plain float32 reference
(``portbench/reference``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` (traced) and ``checks``, each number compared beside its
limit. Without a CUDA device, with fewer than the cell's devices, or with
JAX loaded, the run exits with an error and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
BANNED = ("jax", "jaxlib", "flax", "ganlab_tpu")


def _env() -> None:
    """Fixed cache directories inside the checkout, few host threads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


_env()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


class Fail(Exception):
    """A run that prints no result."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _set(d: dict, dotted: str, value) -> None:
    sec, key = dotted.split(".", 1)
    d.setdefault(sec, {})[key] = value


class Harness:
    """What a driver gets: the cell's configuration and traffic, the
    device, the seed and window length, spans and the window's profiler,
    and the hooks that mark set-up's end and read the memory peak."""

    def __init__(self, args, bench: dict, device, overrides=None,
                 traffic_overrides=None):
        from portbench.trace import Tracer

        self.seed, self.seconds = args.seed, args.seconds
        self.cell = cell = find_cell(bench, args.workload)
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        self.c = load_json(ROOT / conf["file"])
        self.traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{cell['name']}.json")
        changed = dict(self.c["changed"])
        for k, v in (overrides or {}).items():
            changed[k] = v
            _set(self.c, k, v)
        self.traffic.update(traffic_overrides or {})
        self.model = self.c["model"]
        self.device = torch.device(device)
        self.cfg = program_config(self.c["preset"], changed, self.c)
        self.kernel_files = {p.stem: load_json(p)
                             for p in sorted((HERE / "kernels").glob("*.json"))}
        peaks = load_json(HERE / "peaks.json")
        self.peaks = peaks.get(torch.cuda.get_device_name(self.device)) \
            if self.device.type == "cuda" else None
        self.tracer = Tracer(bool(args.trace) and self.device.type == "cuda")
        self.setup_s = None
        self.memory_peak = 0
        self.log = log

    def span(self, name: str):
        return self.tracer.span(name)

    def window(self):
        return self.tracer.window()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - T0

    def read_memory(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    @contextlib.contextmanager
    def reference_precision(self):
        """float32 without TF32, for the reference."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def find_cell(bench: dict, name: str) -> dict:
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise Fail(f"no workload {name!r} in BENCHMARK.json")
    return cell


def program_config(preset: str, changed: dict, stated: dict):
    """The program's configuration: the preset with the file's changed
    keys. Every value the file states must be the program's."""
    from ganlab_tpu_torch.config import get_config

    cfg = get_config(preset, **changed)
    for sec in ("model", "loss", "optim", "data", "run", "aug"):
        for key, want in stated.get(sec, {}).items():
            got = getattr(getattr(cfg, sec), key)
            if got != want:
                raise Fail(f"{preset}: {sec}.{key} is {got!r} in the "
                           f"program's configuration, {want!r} in the file")
    return cfg


def per_layer(h, bench: dict, outcome: dict, e2e: list) -> dict:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    from portbench import readers

    ctx = readers.Context(trace=h.tracer.data, work=outcome["work"],
                          peaks=h.peaks, kernel_files=h.kernel_files,
                          here=HERE)
    out = {}
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if cells is not None and h.cell["name"] not in cells:
            continue
        if cells is None and m["moves"] not in e2e:
            continue
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, *, device=None, overrides=None,
         traffic_overrides=None) -> dict:
    """One run; returns the result. ``device`` / ``overrides`` /
    ``traffic_overrides`` are for tests: a device other than the card,
    configuration keys (dotted) and traffic keys set over the files."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise Fail("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise Fail(f"{cell['name']} needs {cell['chips']} devices, "
                       f"{torch.cuda.device_count()} present")
        device = "cuda:0"
        torch.set_num_threads(4)
    try:
        from ganlab_tpu_torch.ops.kernels import _build
    except ImportError as e:
        raise Fail(f"the program is not in this checkout: {e}")
    if torch.device(device).type == "cuda":
        _build.build_all()      # the first run in a checkout compiles
    h = Harness(args, bench, device, overrides, traffic_overrides)
    driver = load_module(HERE / "drivers" / f"{h.traffic['driver']}.py")
    outcome = driver.run(h)

    e2e_names = [m["name"] for m in bench["end_to_end"]
                 if m.get("workloads") is None
                 or cell["name"] in m["workloads"]]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    values = dict(outcome["end_to_end"], setup_s=h.setup_s)
    if args.trace:
        metrics = per_layer(h, bench, outcome, e2e_names)
    else:
        metrics = {n: {"value": values[n], "unit": units[n]}
                   for n in e2e_names}
    checks = {}
    for name, limit in h.limits.items():
        v = outcome["gaps"][name]
        checks[name] = {"value": v, "limit": limit}
    for name, v in outcome["gaps"].items():
        if name not in checks:
            log(f"reading {name}: {v!r} (not compared)")
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if h.device.type == "cuda" else h.device.type,
           "kind": torch.cuda.get_device_name(h.device)
           if h.device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(h.memory_peak)}
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics, "device": dev}
    if args.trace and h.tracer.data is not None:
        from portbench.trace import breakdown

        log(f"trace: {h.tracer.data.events} device events in the window")
        dev["busy_s"] = h.tracer.data.busy_s
        dev["window_s"] = h.tracer.data.window_s
        result["breakdown"] = breakdown(h.tracer.data)
    result["readings"] = {k: v for k, v in outcome["gaps"].items()
                          if k not in checks}
    result["checks"] = checks
    found = sorted({n.split(".")[0] for n in sys.modules} & set(BANNED))
    if found:
        raise Fail(f"modules loaded in the benchmark's process: {found}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    return result


if __name__ == "__main__":
    try:
        res = main()
    except Fail as e:
        log(f"portbench: {e}")
        sys.exit(2)
    print(json.dumps(res), flush=True)
