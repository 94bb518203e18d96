"""Host-bound timings of one checkout of the PyTorch port, for paired
comparisons of two commits on one card.

    python scripts/host_pair.py ROOT LABEL

imports ``ganlab_tpu_torch`` and ``chip_smoke`` from the checkout at
``ROOT``, builds its kernels and prints one line ``PAIR LABEL: ...``: the
median ms of a ``stylegan2-256`` step with neither regularizer (of steps
4-25) and of a path-length step (of steps 4-12), at the preset's batch of
8, and of a served ``stylegan-256`` batch of 32 (``chip_smoke.
make_sampler``'s weights; of batches 3-12). These steps and batches are
host-bound, so a dearer call of the host shows in them. Run it for the
parent and the change in turns in one call on one card (parent, change,
change, parent), e.g. with each commit unpacked by ``git archive`` into
a git-ignored directory.
"""
import statistics
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ganlab_tpu_torch import get_config  # noqa: E402
from ganlab_tpu_torch.train import build_phases, create_train_state  # noqa
from ganlab_tpu_torch.train import steps as ts  # noqa: E402

cs.phase_build()
out = {}
cfg = get_config("stylegan2-256")
phase = build_phases(cfg.schedule, cfg.model)[-1]
st = create_train_state(cfg, seed=0)
g = torch.Generator(device="cuda").manual_seed(1)
real = torch.randint(0, 256, (8, 256, 256, 3), generator=g, device="cuda",
                     dtype=torch.uint8)
for name, pl in (("sg2 neither", False), ("sg2 pl", True)):
    step = ts.build_train_step(cfg, phase, penalty_override=False,
                               pl_override=pl)
    ms = []
    for i in range(12 if pl else 25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, real)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out[name] = statistics.median(ms[3:])
s = cs.make_sampler(get_config("stylegan-256"))
s.generate(32, seed=0)
lat = []
for i in range(12):
    t0 = time.perf_counter()
    s.generate(32, seed=i)
    lat.append((time.perf_counter() - t0) * 1e3)
out["serve sg256 batch ms"] = statistics.median(lat[2:])
print(f"PAIR {label}: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()),
      flush=True)
