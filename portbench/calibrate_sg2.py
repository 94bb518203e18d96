"""The readings that the limits of the StyleGAN2 training cell are set
from, on the card at the cell's own size: ``calibrate.py``'s, with the
path-length term's gaps and faults.

    python3 portbench/calibrate_sg2.py --workload sg2f-256-train-b32-pl \
        --first-seed <n> --seeds 12 --control-seeds 3 [--seconds 0]

Lower readings: sound runs of the program, one a seed, through
``run.main`` with ``min_cycles`` 0 (``calibrate.lower``). Upper readings,
on ``--control-seeds`` seeds, each put in the program's place and held to
the float32 reference with the driver's gaps (``drivers/train_sg2.py``):
the control (float8 e4m3 operands in the convs and dense layers, the
precision below the configuration's bfloat16), and the planted faults
``half_batch`` (every batch mean after the forward over half the rows),
``pl_off`` (the path-length penalty reported but left out of G's
objective), ``pl_half`` (the path lengths over half their rows), each
over step 0 and the stage followed from its own state, and
``unchanged`` (a state left unchanged: reads 1 on the change by
construction, followed over the stage). Prints one JSON line a reading
and a summary line last.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
spec = importlib.util.spec_from_file_location("portbench_calibrate",
                                              HERE / "calibrate.py")
cal = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cal)
run = cal.run

import torch  # noqa: E402

from portbench.reference import model as M  # noqa: E402
from portbench.reference.compare import stage_gaps  # noqa: E402

FAULTS = ("half_batch", "pl_off", "pl_half")


def upper(h, driver, seed, faults=FAULTS) -> list:
    """The control and the ``faults`` in the program's place, each held
    to the float32 reference at step 0 from the seed and over the stage
    followed from the state its own step 0 left; then a state left
    unchanged."""
    batches = list(range(1, h.traffic["stage_steps"] + 1))
    ref = driver.reference(h, None, batches, keep_state=True)
    snap = ref.pop("state")
    rows = []
    for kind, kw in [("control_fp8", {"prec": M.FP8})] + [
            (f"fault_{f}", {"fault": f}) for f in faults]:
        got = driver.reference(h, None, batches, keep_state=True, **kw)
        own = got.pop("state")
        got["stage"] = driver.stage_reference(h, own, batches, **kw)
        want = dict(ref, stage=driver.stage_reference(h, own, batches))
        del own
        rows.append({"kind": kind, "seed": seed, **driver.gaps(got, want),
                     "stage_rows": got["stage"],
                     "stage_ref_rows": want["stage"]})
    if faults:
        got = driver.stage_reference(h, snap, batches, fault="unchanged")
        want = driver.stage_reference(h, snap, batches)
        rows.append({"kind": "fault_unchanged", "seed": seed,
                     "adam_step_err": 1.0, "ema_step_err": 1.0,
                     **stage_gaps(got, want),
                     "stage_traj_err": driver.stage_traj_gap(got, want),
                     "stage_rows": got, "stage_ref_rows": want})
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args()
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.find_cell(bench, args.workload)
    traffic = run.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    rows = cal.lower(args, args.workload, "train")
    driver = run.load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    for j in range(args.control_seeds):
        seed = args.first_seed + 1000 + j
        a = argparse.Namespace(workload=args.workload, seed=seed,
                               seconds=0.0, trace=0)
        h = run.Harness(a, bench, "cuda:0")
        for r in upper(h, driver, seed):
            print(json.dumps(r), flush=True)
            rows.append(r)
        del h
        torch.cuda.empty_cache()
    summary = {}
    for r in rows:
        for k, v in r.items():
            if k in ("kind", "seed") or not isinstance(v, (int, float)):
                continue
            summary.setdefault(r["kind"], {}).setdefault(k, []).append(v)
    print(json.dumps({"summary": {kk: {k: [min(v), max(v)]
                                       for k, v in d.items()}
                                  for kk, d in summary.items()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except run.Fail as e:
        print(f"calibrate_sg2: {e}", file=sys.stderr)
        sys.exit(2)
