"""Deterministic fault injection: named points, counted occurrences.

Every instrumented site calls :func:`fire` with its site name (and an
optional qualifier such as a replica id), the harness counts occurrences
per ``(site, qualifier)``, and a spec entry matching the current count
triggers exactly once. With no plan armed, ``fire`` is a lookup
returning ``None``.

Spec grammar (``DL4J_TORCH_FAULT_SPEC`` or :func:`install`/:func:`inject`)::

    spec     := entry ("," entry)*
    entry    := site ("[" qual "]")? "@" N (":" param)?
    site     := injection-point name (see table below)
    qual     := instance qualifier; an entry without one matches only
                unqualified fire() calls
    N        := 0-based occurrence index at which the fault triggers
    param    := site-specific argument (e.g. a sleep duration)

Wired sites (``serving/``, ``datasets/async_iterator.py``,
``models/multi_layer_network.py``, ``utils/atomic_io.py``,
``parallel/coordinator.py`` and ``parallel/elastic.py``):

=====================  =====================================================
``queue-overflow``     submit N sees a full request queue and fails fast
                       with ``ServeQueueFullError``
``client-disconnect``  request N's future is cancelled right before its
                       result lands; the loop discards it and serves on
``slow-request``       the batch loop sleeps ``param`` seconds (default
                       0.05) before dispatch N
``kill-replica``       the serving loop exits without cleanup right before
                       dispatch N (a hard crash; ``healthy()`` turns False);
                       qualifier is the replica id
``slow-replica``       the serving loop sleeps ``param`` seconds (default
                       0.5) before dispatch N; qualifier is the replica id
``expire-deadline``    deadline-sweep check N treats its request as
                       expired: it fails ``ServeDeadlineError`` before
                       dispatch
``nan-step``           train dispatch N poisons its float inputs with NaN
                       (its labels when the features are integers), so
                       the non-finite guard must revert it: a
                       ``MultiLayerNetwork.fit_batch`` call (every tBPTT
                       window of it) or a ``fit_fused`` group, where
                       ``param`` is the step of the group (default 0)
``iter-raise``         the prefetch worker raises ``RuntimeError`` instead
                       of delivering base-iterator batch N (every pull
                       counts)
``slow-batch``         the prefetch worker sleeps ``param`` seconds
                       (default 0.1) before handling batch N
``kill-worker``        the prefetch worker thread exits WITHOUT its
                       end-of-stream sentinel at batch N (a hard crash);
                       the consumer raises ``PrefetchWorkerDiedError``
``kill-during-ckpt``   checkpoint commit N raises between its temporary
                       write and the rename (a process death at the worst
                       moment): the previous checkpoint stays as it was
``corrupt-ckpt``       commit N damages the file it has just committed;
                       qualifier ``truncate`` cuts it in half, ``bitflip``
                       flips one bit at byte ``param`` (default: the
                       middle)
``drop-conn``          the Python collective client closes its socket and
                       raises ``ConnectionError`` before wire request N
                       (request 0 is its JOIN): a worker dying mid-run;
                       qualifier is the worker id
``kill-peer``          an elastic participant dies mid-fit before heartbeat
                       N (between heartbeats, never inside a collective): an
                       ``ElasticMember`` closes its connection and leaves
                       without re-forming; an ``ElasticTrainer`` process
                       exits at once (``os._exit``), its sockets and its
                       process-group pairs closed by the OS; qualifier is
                       the participant's initial worker id
``slow-peer``          an elastic participant sleeps ``param`` seconds
                       (default 1.0) before heartbeat N: a straggler past
                       the round deadline, which the coordinator must
                       expel (departed and re-formed around), never wait
                       for forever; qualifier is its initial worker id
=====================  =====================================================

Tests prefer the :func:`inject` context manager, which arms a plan and
resets all occurrence counters on entry and disarms on exit.
"""

from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass

from deeplearning4j_tpu_torch.config import env_str

__all__ = ["FaultSpec", "fire", "install", "clear", "inject", "reset",
           "parse_spec"]


@dataclass(frozen=True)
class FaultSpec:
    site: str
    at: int             # 0-based occurrence index that triggers
    qual: str | None    # instance qualifier
    param: str | None   # site-specific argument, raw string

    def param_float(self, default):
        try:
            return float(self.param)
        except (TypeError, ValueError):
            return default

    def param_int(self, default):
        try:
            return int(self.param)
        except (TypeError, ValueError):
            return default


_ENTRY_RE = re.compile(
    r"^(?P<site>[A-Za-z][\w-]*)(?:\[(?P<qual>[^\]]*)\])?"
    r"@(?P<at>\d+)(?::(?P<param>.*))?$")

_lock = threading.Lock()
_installed: str | None = None            # programmatic override, wins over env
_parsed: tuple[str, tuple] = ("", ())    # cache keyed by the raw spec string
_counters: dict = {}                     # (site, qual) -> occurrences so far


def parse_spec(raw):
    """Parse a spec string to a tuple of :class:`FaultSpec`. Malformed
    entries raise ``ValueError`` naming the entry: a half-armed plan
    would defeat its purpose."""
    out = []
    for entry in (raw or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        m = _ENTRY_RE.match(entry)
        if m is None:
            raise ValueError(
                f"malformed fault spec entry {entry!r} (grammar: "
                "site[qual]@N[:param], see testing/faults.py)")
        out.append(FaultSpec(m.group("site"), int(m.group("at")),
                             m.group("qual"), m.group("param")))
    return tuple(out)


def _plan():
    global _parsed
    raw = _installed if _installed is not None \
        else env_str("DL4J_TORCH_FAULT_SPEC")
    if raw == _parsed[0]:
        return _parsed[1]
    plan = parse_spec(raw)
    _parsed = (raw, plan)
    return plan


def fire(site, qual=None):
    """Advance the ``(site, qual)`` occurrence counter and return the
    matching :class:`FaultSpec` if this occurrence is scheduled to fail,
    else ``None``. With no plan armed the counters do not advance."""
    plan = _plan()
    if not plan:
        return None
    key = (site, qual if qual is None else str(qual))
    with _lock:
        n = _counters.get(key, 0)
        _counters[key] = n + 1
    for spec in plan:
        if spec.site == site and spec.at == n and spec.qual == key[1]:
            return spec
    return None


def install(spec):
    """Arm a plan programmatically (overrides the env knob) and reset
    counters; ``install(None)`` re-enables the env knob."""
    global _installed
    with _lock:
        _counters.clear()
    _installed = spec
    if spec is not None:
        parse_spec(spec)   # fail fast on malformed plans


def clear():
    """Disarm programmatic plans and zero every counter."""
    install(None)
    reset()


def reset():
    """Zero the occurrence counters (the plan stays armed)."""
    with _lock:
        _counters.clear()


@contextmanager
def inject(spec):
    """Arm ``spec`` for the duration of a ``with`` block::

        with faults.inject("queue-overflow@0"):
            ...
    """
    install(spec)
    try:
        yield
    finally:
        clear()
