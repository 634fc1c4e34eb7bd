"""Training cells: one model object, built in set-up from the seed, driven
through its first steps (which the reference then follows), warmed up,
and handed to the timed window, all through the family's ``fit`` call
on the pool of batches a user's loop would hand it.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import check
from perfbench.families.tree import flatten
from perfbench.reference.common import strict_f32


def _norms(tree):
    return {n: float(torch.linalg.vector_norm(t.detach().double()))
            for n, t in tree.items()}


def run(job):
    fam, cfg, tr, dev = job.family, job.cfg, job.traffic, job.device
    b1 = cfg["optimizer"]["beta1"]
    batches = fam.train_batches(cfg, tr, job.seed, dev)
    model = fam.port_model(cfg, fam.init_weights(cfg, job.seed, dev), dev)
    job.fault(model)
    n_checked = tr["checked_steps"]

    # the checked steps: each loss, the first gradient as the optimizer
    # holds it (m = (1 - beta1) g after one step), the change after all
    prog = {"losses": []}
    for i in range(n_checked):
        prog["losses"].append(float(fam.fit(model, batches[i])))
        if i == 0:
            prog["grad"] = {n: v / (1 - b1) for n, v in
                            _norms(flatten(model.opt_state["m"])).items()}
    w0 = fam.init_weights(cfg, job.seed, dev)
    prog["change"] = {n: (p.detach() - w0[n]).cpu()
                      for n, p in flatten(model.params).items()}
    del w0
    step = n_checked
    for _ in range(tr["warm_steps"]):
        fam.fit(model, batches[step % len(batches)])
        step += 1
    job.setup_done()

    t0 = time.perf_counter()
    n = 0
    while True:
        loss = fam.fit(model, batches[step % len(batches)])
        step += 1
        n += 1
        if time.perf_counter() - t0 >= job.seconds:
            break
    last = float(loss)   # waits for the device
    window_s = time.perf_counter() - t0
    job.measure.step_s = window_s / n
    job.measure.steps = n
    job.measure.flops_per_step = fam.train_flops(cfg, tr)
    job.measure.flash_calls = fam.flash_calls(cfg, tr)
    job.e2e["train_step_ms"] = window_s / n * 1e3

    if job.trace:
        k = tr["trace_steps"]
        rec = job.recorder()
        rec.start()
        rec.open()
        for _ in range(k):
            fam.fit(model, batches[step % len(batches)])
            step += 1
        rec.close()
        rec.stop()
        job.measure.trace = rec.result()
        job.measure.steps_traced = k
    job.read_memory_peak()
    job.attempted, job.failed = n, 0 if math.isfinite(last) else 1

    del model
    job.free()
    w = fam.init_weights(cfg, job.seed, dev)
    w0 = {k: v.clone() for k, v in w.items()}
    ref_batches = [fam.reference_batch(b, dev) for b in batches[:n_checked]]
    with strict_f32():
        losses, first = fam.reference_train(cfg, w, ref_batches,
                                            tr["reference_rows"])
    ref = {"losses": losses, "grad": first,
           "change": {k: w[k] - w0[k] for k in w}}
    numbers, where = check.train_numbers(prog, ref)
    job.numbers.update(numbers)
    job.notes.update(where)
    job.reference = ref
