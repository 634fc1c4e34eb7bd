"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each with the limit the cell's file sets.

Training compares the first steps that the window's own object took:
each step's loss, the first gradient as the optimizer holds it, and each
parameter's change over those steps. Norms are compared leaf by leaf,
the gap between the program's norm and the reference's, against the
larger of the reference's norm of that leaf and of the median leaf.
Serving compares served tokens against the reference's logits at the
same positions. Greedy tokens: the widest gap by which a served token's
logit lies below the reference's best. Sampled tokens (temperature and
top_p): how far past top_p the reference's mass ranked above a served
token reaches (the nucleus keeps a token while that mass is under
top_p), and how far the served tokens' log-probabilities at the
temperature stray from their mean over the reference's nucleus, in
standard deviations of their sum. The nucleus is taken at temperature 1
and the temperature applied inside it, as the program's sampler states
(``TransformerLM._filter_logits_rows``, then ``/ temperature``).
"""

from __future__ import annotations

import math
import statistics

import torch

# an element whose first gradient in the reference is under this share
# of the median leaf's (root mean square) is nought to rounding, as a
# key's bias is under softmax: Adam moves it by round-off alone, so it is
# left out of the change on both sides
STILL = 1e-3


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gap(prog, ref):
    """max over leaves of | |p| - |r| | / max(|r|, median |r|), with the
    leaf that sets it. ``prog`` and ``ref`` map leaf names to norms."""
    med = statistics.median(ref.values())
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in ref}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog, ref):
    """prog: {"losses", "grad" (leaf norms), "change" (leaf tensors)};
    ref: {"losses", "grad" (leaf tensors), "change" (leaf tensors)}.
    Returns ({name: value}, {what set each, and what was left out})."""
    rms = {n: _norm(g) / math.sqrt(g.numel()) for n, g in ref["grad"].items()}
    floor = STILL * statistics.median(rms.values())
    pc, rc, left = {}, {}, 0
    for n, g in ref["grad"].items():
        moving = g.abs() >= floor
        left += int(moving.numel() - moving.sum())
        if moving.any():
            rc[n] = _norm(ref["change"][n][moving])
            pc[n] = _norm(prog["change"][n].to(g.device)[moving])
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))
    grad, gw = leaf_gap(prog["grad"], {n: _norm(g)
                                       for n, g in ref["grad"].items()})
    change, cw = leaf_gap(pc, rc)
    return ({"loss_gap": loss, "grad_gap": grad, "change_gap": change},
            {"grad_gap": gw, "change_gap": cw, "still_elements": left,
             "still_leaves": sorted(set(ref["grad"]) - set(rc))})


def token_gaps(ref_logits, served):
    """Per position: the reference's best logit less its logit of the
    served token. ref_logits [N, V] float32, served [N] int64."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served[:, None])[:, 0]
    return best - got


def _nucleus(logits, top_p):
    """[N, V] bool: the tokens the nucleus of ``top_p`` keeps, by the
    mass ranked above each token at temperature 1 (a stable sort, so of
    tied logits the lower id ranks first); float64 logits."""
    idx = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(logits, -1).gather(-1, idx)
    keep = (torch.cumsum(probs, -1) - probs) < top_p
    return torch.zeros_like(keep).scatter(-1, idx, keep)


def sampled_terms(ref_logits, served, temperature, top_p):
    """Per position of one sampled request: the reference's mass ranked
    above the served token, the token's log-probability at the
    temperature, and that log-probability's mean and variance over the
    served distribution (the reference's nucleus, at the temperature).
    ref_logits [N, V] float32, served [N] int64; four [N] float64."""
    lg = ref_logits.double()
    t = served[:, None]
    at = lg.gather(-1, t)
    ids = torch.arange(lg.shape[-1], device=lg.device)
    ahead = (lg > at) | ((lg == at) & (ids[None, :] < t))
    above = (torch.softmax(lg, -1) * ahead).sum(-1)
    score = torch.log_softmax(lg / temperature, -1)
    q = torch.softmax(score.masked_fill(~_nucleus(lg, top_p), -math.inf), -1)
    mean = (q * score).sum(-1)
    var = (q * score.square()).sum(-1) - mean.square()
    return above, score.gather(-1, t)[:, 0], mean, var


def sampled_numbers(terms):
    """``nucleus_excess``: how far past its top_p the mass ranked above
    any served token reaches (0 where every token lies in its nucleus);
    ``sample_z``: |sum of (score - mean)| / sqrt(sum of var) over every
    position. ``terms`` is a list of (top_p, sampled_terms(...))."""
    if not terms:
        return {"nucleus_excess": 0.0, "sample_z": 0.0}
    excess = max(float((above - p).max()) for p, (above, *_) in terms)
    dev = sum(float((s - m).sum()) for _, (_, s, m, _v) in terms)
    var = sum(float(v.clamp(min=0).sum()) for _, (*_, v) in terms)
    return {"nucleus_excess": max(excess, 0.0),
            "sample_z": abs(dev) / math.sqrt(var) if var > 0 else 0.0}


def draw(logits, temperature, top_p, gen):
    """Tokens drawn from ``logits`` [N, V] as the served sampler states
    them (the nucleus of top_p at temperature 1, then the temperature),
    by the Gumbel-max rule with noise from ``gen``: how the control and
    the planted sampler faults stand in the program's place."""
    lg = logits.double()
    u = torch.rand(lg.shape, generator=gen, device=lg.device,
                   dtype=torch.float64)
    noise = -torch.log(-torch.log(u.clamp(min=1e-300)))
    scaled = (lg / temperature).masked_fill(~_nucleus(lg, top_p), -math.inf)
    return (scaled + noise).argmax(-1)


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number finite and at most
    its limit."""
    rows = [(n, float(numbers[n]), float(limits[n])) for n in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
