#!/usr/bin/env python3
"""How two ContinuousLM replicas over one model share one GPU: the
package's way against two variants, by the rows they serve and their
speed.

Run from the repository root on a host with an H100::

    python3 serve_variants.py

Two replicas of bench.py's bench_serve model (V 2048, d 256, L 4, f32;
8 slots, chunk 8) behind ``ReplicaRouter``, each warm-started, serve a
4-client closed loop of 64 requests (prompts of 8 and 16 tokens, n_new
16). Each variant runs in a process of its own:

- ``default``: the package: both schedulers launch on the device's
  default stream, so the card runs their graphs one after another;
- ``streams``: each scheduler on a CUDA stream of its own, so the
  replicas' graphs may run at once;
- ``streams_no_workspace``: the same with cuBLAS and cuBLASLt given no
  workspace (``CUBLAS_WORKSPACE_CONFIG=:0:0``, ``CUBLASLT_WORKSPACE_SIZE=0``).

For each it prints one JSON line: how many rows differ from
``generate()`` of their prompt on the card, tokens/s, and a profile of
one more burst (kernels' device time against the time any kernel ran:
their overlap), beside the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

VARIANTS = {"default": {}, "streams": {},
            "streams_no_workspace": {"CUBLAS_WORKSPACE_CONFIG": ":0:0",
                                     "CUBLASLT_WORKSPACE_SIZE": "0"}}
CLIENTS, PER_CLIENT = 4, 16


def _stream_each_loop(self):
    """ContinuousLM's scheduler on a stream of its own (the variant)."""
    import torch
    torch.cuda.set_device(self.device)
    stream = torch.cuda.Stream(self.device)
    stream.wait_stream(torch.cuda.current_stream(self.device))
    try:
        with torch.cuda.stream(stream), torch.no_grad():
            self._decode_loop()
    finally:
        stream.synchronize()


def run(variant):
    import numpy as np
    import torch
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.serving import ContinuousLM, ReplicaRouter
    torch.backends.cuda.matmul.allow_tf32 = False
    if variant != "default":
        ContinuousLM._loop = _stream_each_loop
    cfg = cs.SERVE_SCALE
    lm = cs._serve_lm(cfg["model"])
    V, n_new = cfg["model"]["vocab_size"], cfg["n_new"]
    rng = np.random.default_rng(0)

    def burst(n):
        return [rng.integers(1, V, (cfg["prompts"][i % 2],))
                .astype(np.int32) for i in range(n)]
    reps = [ContinuousLM(lm, slots=cfg["slots"], chunk=cfg["chunk"])
            for _ in range(2)]
    router = ReplicaRouter(reps, heartbeat_s=3600.0, slo_ms=0.0)
    work = [burst(PER_CLIENT) for _ in range(CLIENTS)]
    rows, lock = [], threading.Lock()

    def client(k):
        for p in work[k]:
            row = router.submit(p, n_new).result(600)
            with lock:
                rows.append((p, row))
    try:
        router.warm_start()
        for p in burst(4):
            router.submit(p, n_new).result(600)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=client, args=(k,))
              for k in range(CLIENTS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        dt = time.perf_counter() - t0
        more = burst(16)
        prof = cs.profiled_streams(lambda: [
            f.result(600) for f in [router.submit(p, n_new) for p in more]])
    finally:
        router.stop()
    differ = sum(not np.array_equal(r, lm.generate(p[None, :], n_new,
                                                   temperature=0.0)[0])
                 for p, r in rows)
    print(json.dumps({"variant": variant, "rows": len(rows),
                      "differ_from_generate": differ,
                      "tokens_per_s": len(rows) * n_new / dt,
                      "profile_burst_of_16": prof,
                      "card": cs.card_line()}), flush=True)


def main():
    try:
        import torch
    except ImportError:
        print("serve_variants: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("serve_variants: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return 0
    root = Path(__file__).resolve().parent
    for variant, env in VARIANTS.items():
        subprocess.run([sys.executable, __file__, variant], cwd=root,
                       env={**os.environ, **env}, check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main())
