"""The readings that the limits of ``portbench/limits/<cell>.json`` are set
from, on the card at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --first-seed <n> \
        --seeds 12 --control-seeds 3 [--seconds 2]

Lower readings: sound runs of the program, one a seed, through
``run.main`` (set-up, a short window, the check), their gaps to the
reference. Upper readings, on ``--control-seeds`` seeds: the control (the
reference computed with float8 e4m3 operands in the convs and dense
layers, the precision below the configuration's bfloat16) and the planted
faults, each put in the program's place and held to the float32
reference: training, half of the batch left out after the forward (every
batch mean, of the losses, R1 and the w-average, over the rest) and a
state left unchanged (reads 1 on the change by construction, and is
followed over the stage steps);
serving, half of the batch's images left out (zeros) and an answer
altered where it is produced (image 0 of a request swapped for image 1).
Prints one JSON line a reading and a summary line last.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
spec = importlib.util.spec_from_file_location("portbench_run", HERE / "run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)

import torch  # noqa: E402

from portbench.reference import model as M  # noqa: E402
from portbench.reference import serve as ref_serve  # noqa: E402
from portbench.reference.compare import (  # noqa: E402
    image_gap,
    stage_gaps,
    train_gaps,
)


def lower(args, cell, traffic_kind):
    over = {"min_cycles": 0} if traffic_kind == "train" else {}
    out = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        res = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                        str(args.seconds), "--trace", "0"],
                       traffic_overrides=over)
        row = {"kind": "program", "seed": seed, **res["readings"],
               **{k: v["value"] for k, v in res["checks"].items()}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def upper_train(h, driver, seed, faults=True):
    """The control and the faults in the program's place, each held to
    the float32 reference: at step 0 from the seed, and (the control and
    a state left unchanged) over the stage steps, followed from the state
    that this side's own step 0 left."""
    batches = list(range(1, h.traffic["stage_steps"] + 1))
    ref = driver.reference(h, None, batches, keep_state=True)
    snap = ref.pop("state")
    runs = [("control_fp8", {"prec": M.FP8})]
    if faults:
        runs.append(("fault_half_batch", {"fault": "half_batch"}))
    rows = []
    for kind, kw in runs:
        ctl = kind == "control_fp8"
        got = driver.reference(h, None, batches, keep_state=ctl, **kw)
        want = dict(ref)
        if ctl:
            own = got.pop("state")
            got["stage"] = driver.stage_reference(h, own, batches, **kw)
            want["stage"] = driver.stage_reference(h, own, batches)
            del own
        rows.append({"kind": kind, "seed": seed, **train_gaps(got, want),
                     **_stage_rows(got, want)})
    if faults:
        # a state left unchanged: a change of nought reads 1 against the
        # reference's on every element and on the w-average
        got = driver.stage_reference(h, snap, batches, fault="unchanged")
        want = driver.stage_reference(h, snap, batches)
        rows.append({"kind": "fault_unchanged", "seed": seed,
                     "adam_step_err": 1.0, "ema_step_err": 1.0,
                     **stage_gaps(got, want),
                     **_stage_rows({"stage": got}, {"stage": want})})
    return rows


def _stage_rows(got, want) -> dict:
    """The stage metrics of both sides, for the readings."""
    if "stage" not in got:
        return {}
    return {"stage_rows": got["stage"], "stage_ref_rows": want["stage"]}


def upper_serve(h, driver, seed, requests=9):
    m, dev, B = h.model, h.device, h.traffic["batch"]
    from portbench import inputs

    P_g, _ = inputs.weights(m, seed, dev)
    w_avg = inputs.w_avg(m, seed, dev)
    dtype = getattr(torch, h.c["run"]["compute_dtype"])
    psi = m["truncation_psi"]
    worst = {"control_fp8": 0.0, "fault_half_batch": 0.0,
             "fault_altered_answer": 0.0}
    with h.reference_precision():
        for i in range(requests):
            rs = inputs.request_seed(seed, i)
            z = ref_serve.latents(B, m["latent_dim"], rs).to(dev)
            noise = ref_serve.noises(m, B, rs, 0, dev, dtype)
            want = ref_serve.sample_u8(P_g, m, w_avg, z, noise, psi)
            ctl = ref_serve.sample_u8(P_g, m, w_avg, z, noise, psi, M.FP8)
            half = want.clone()
            half[B // 2:] = 0
            alt = want.clone()
            alt[0] = want[1]
            for k, got in (("control_fp8", ctl), ("fault_half_batch", half),
                           ("fault_altered_answer", alt)):
                worst[k] = max(worst[k], image_gap(got, want))
    return [{"kind": k, "seed": seed, "image_gap": v}
            for k, v in worst.items()]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--no-faults", action="store_true",
                   help="training: the control alone")
    args = p.parse_args()
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.find_cell(bench, args.workload)
    traffic = run.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    kind = "train" if traffic["driver"] == "train" else "serve"
    rows = lower(args, args.workload, kind)
    driver = run.load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    for j in range(args.control_seeds):
        seed = args.first_seed + 1000 + j
        a = argparse.Namespace(workload=args.workload, seed=seed,
                               seconds=0.0, trace=0)
        h = run.Harness(a, bench, "cuda:0")
        new = upper_train(h, driver, seed, not args.no_faults) \
            if kind == "train" \
            else upper_serve(h, driver, seed)
        for r in new:
            print(json.dumps(r), flush=True)
        rows += new
        del h
        torch.cuda.empty_cache()
    summary = {}
    for r in rows:
        for k, v in r.items():
            if k in ("kind", "seed") or not isinstance(v, (int, float)):
                continue
            s = summary.setdefault(r["kind"], {}).setdefault(k, [])
            s.append(v)
    print(json.dumps({"summary": {kk: {k: [min(v), max(v)]
                                       for k, v in d.items()}
                                  for kk, d in summary.items()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except run.Fail as e:
        print(f"calibrate: {e}", file=sys.stderr)
        sys.exit(2)
