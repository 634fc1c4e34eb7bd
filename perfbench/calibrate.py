"""Readings that set the limits of a cell's ``correct``, taken on the card
at the cell's own size: the program on many seeds (the lower readings),
the control on a few (the reference computed in float8, the precision
below the configurations' bfloat16, in the program's place) and the
planted faults of ``perfbench/faults.py`` on a few. The benchmark's own
runs never run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 4 5 6 --fault-seeds 4 5 6 --faults half_batch \
        [--seconds 2]

Prints one JSON line a reading; the control's lines carry ``"as":
"control"``, a fault's its name. In a serving cell each control seed
also reads the sampler faults in the reference's place
(``top_p_ignored``, ``temperature_ignored``).
"""

import sys
import time

T_START = time.monotonic()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from perfbench import check, faults, harness, seeds  # noqa: E402
from perfbench.reference.common import strict_f32  # noqa: E402


def _control_training(job):
    """The reference in float8 over the same checked steps, held against
    the float32 reference as the program is."""
    fam, cfg, tr, dev = job.family, job.cfg, job.traffic, job.device
    n = tr["checked_steps"]
    batches = [fam.reference_batch(b, dev) for b in
               fam.train_batches(cfg, tr, job.seed, dev)[:n]]
    w = fam.init_weights(cfg, job.seed, dev)
    w0 = {k: v.clone() for k, v in w.items()}
    losses, first = fam.reference_train(cfg, w, batches,
                                        tr["reference_rows"], "fp8")
    prog = {"losses": losses,
            "grad": {k: float(torch.linalg.vector_norm(g.double()))
                     for k, g in first.items()},
            "change": {k: w[k] - w0[k] for k in w}}
    del w, w0, first
    return check.train_numbers(prog, job.reference)


def _control_serving(job):
    """At each served position of the compared requests, the token the
    float8 reference puts first (greedy), or draws as the served sampler
    does (sampled), read on the float32 reference's logits. Beside it,
    the planted sampler faults in the reference's place: the float32
    reference drawing with top_p left out, or with the temperature left
    out. Returns (the control's numbers, {"faults": {fault: numbers}}).
    """
    fam, cfg, dev = job.family, job.cfg, job.device
    w = fam.init_weights(cfg, job.seed, dev)
    worst = 0.0
    out = {k: [] for k in ("control", "top_p_ignored",
                           "temperature_ignored")}
    with torch.no_grad():
        for r, toks in job.served:
            ref, _ = fam.reference_served(cfg, w, r.prompt, toks, dev)
            low, _ = fam.reference_served(cfg, w, r.prompt, toks, dev,
                                          "fp8")
            worst = max(worst, float(check.token_gaps(
                ref, low.argmax(-1)).max()))
        gen = seeds.device(job.seed, "calibrate.draws", dev)
        for r, toks in job.served_sampled:
            ref, _ = fam.reference_served(cfg, w, r.prompt, toks, dev)
            low, _ = fam.reference_served(cfg, w, r.prompt, toks, dev,
                                          "fp8")
            T, p = r.temperature, r.top_p
            for name, lg, t, pp in (("control", low, T, p),
                                    ("top_p_ignored", ref, T, 1.0),
                                    ("temperature_ignored", ref, 1.0, p)):
                drawn = check.draw(lg, t, pp, gen)
                out[name].append((p, check.sampled_terms(ref, drawn, T, p)))
    numbers = {k: check.sampled_numbers(v) for k, v in out.items()}
    control = dict(numbers.pop("control"), greedy_gap=worst, lost=0)
    return control, {"faults": numbers}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    torch.cuda.set_device(0)

    def reading(seed, fault=None):
        t = time.monotonic()
        res, job = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                    False, "cuda:0", t, fault=fault)
        return job, {"seed": seed, "correct": res["correct"],
                     "numbers": job.numbers, "notes": job.notes,
                     "e2e": job.e2e, "s": time.monotonic() - t}

    def emit(line):
        print(json.dumps(line), flush=True)

    for seed in args.seeds:
        emit(dict(reading(seed)[1], **{"as": "program"}))
    for seed in args.control_seeds:
        job, line = reading(seed)
        emit(dict(line, **{"as": "program"}))
        control = _control_serving if job.traffic["driver"] == "serve" \
            else _control_training
        with strict_f32():
            numbers, notes = control(job)
        planted = notes.pop("faults", {})
        emit({"as": "control", "seed": seed, "numbers": numbers,
              "notes": notes})
        for name, nums in planted.items():
            emit({"as": name, "seed": seed, "numbers": nums})
        del job
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        for name in args.faults:
            emit(dict(reading(seed, faults.FAULTS[name])[1], **{"as": name}))
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
