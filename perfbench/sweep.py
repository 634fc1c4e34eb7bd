"""The rate sweep of an open-loop serving cell, on the card: the cell at
each rate given, in one process, for ``--seconds`` each. A rate is
sustained when no request is lost and the backlog does not grow: the
median time to first token of the window's last quarter of requests is
under twice that of its first quarter.

    python3 perfbench/sweep.py --workload <cell> --rates 4 6 8 \
        --seconds 30 --seed 1

Prints one JSON line a rate; the benchmark's runs never run this.
"""

import sys
import time

from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    torch.cuda.set_device(0)
    for rate in args.rates:
        t = time.monotonic()
        res, job = harness.run_cell(ROOT, args.workload, args.seed,
                                    args.seconds, False, "cuda:0", t,
                                    overrides={"rate": rate})
        reqs = sorted(job.requests, key=lambda r: r.due)
        q = max(len(reqs) // 4, 1)

        def med(rs):
            return statistics.median(
                (r.arrivals[0][0] - r.due) * 1e3 if r.arrivals
                else float("inf") for r in rs)
        first, last = med(reqs[:q]), med(reqs[-q:])
        print(json.dumps({
            "rate": rate, "requests": len(reqs), "lost": job.numbers["lost"],
            "ttft_p95_ms": job.e2e["ttft_p95_ms"],
            "tpot_p95_ms": job.e2e["tpot_p95_ms"],
            "ttft_median_first_quarter_ms": first,
            "ttft_median_last_quarter_ms": last,
            "backlog_grew": last > 2 * first,
            "sustained": job.numbers["lost"] == 0 and last <= 2 * first,
            "correct": res["correct"]}), flush=True)
        del job
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
