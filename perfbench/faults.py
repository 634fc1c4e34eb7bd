"""Faults planted in the timed path, for the tests and the calibration
that show the comparison catches them: each takes what ``job.fault``
receives (the model, or the server after its warm-up) and breaks it in
place."""

from __future__ import annotations

import copy


def unchanged(model):
    """Every step runs and reports its loss, then puts the parameters
    back as they were."""
    step = model.fit_batch

    def fit_batch(*args):
        params = copy.deepcopy(model.params)
        loss = step(*args)
        model.params = params
        return loss
    model.fit_batch = fit_batch


def half_batch(model):
    """Every step leaves out the second half of its rows: the mean is
    taken over the rest."""
    step = model.fit_batch
    model.fit_batch = lambda *args: step(*(a[:len(a) // 2] for a in args))


def altered_token(server):
    """Every served row's first new token comes back one id higher."""
    pool = server._pool
    fetch = pool.out_rows
    vocab = server.lm.conf.vocab_size

    def out_rows():
        out = fetch()
        out[:, 0] = (out[:, 0] + 1) % vocab
        return out
    pool.out_rows = out_rows


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_token": altered_token}
