"""Run one benchmark cell once on the card and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit, which also end standard error. Exits
2, printing no result, without enough CUDA devices for the cell, and 3
if JAX or the JAX package was loaded in this process.
"""

import sys
import time

T_START = time.monotonic()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, this folder heads sys.path, where its modules would
# shadow the standard library's (trace): the checkout's root goes there
if Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


def _cache_dirs():
    """The program's one cache directory the environment names, the
    autotuner's, at a fixed place inside the checkout (its kernels build
    into the package's own ``_build/``, inside the checkout too): only a
    cell's first run there builds."""
    os.environ["DL4J_TORCH_TUNE_CACHE_DIR"] = str(
        ROOT / ".perfbench_cache" / "tune")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    import torch

    from perfbench import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, job = harness.run_cell(ROOT, args.workload, args.seed,
                                   args.seconds, bool(args.trace), "cuda:0",
                                   T_START, chips=chips)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["card"] = card_line()
    result["checks"] = result.pop("checks")
    print(json.dumps({"notes": job.notes, "setup_s": job.setup_s,
                      "e2e": job.e2e}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
