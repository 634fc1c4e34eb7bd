"""Runtime random-stream watcher: the torch counterpart of
``deeplearning4j_tpu/testing/rngwatch.py``.

The reference's violation is one ``jax.random`` key generation consumed
twice. The port has no keys to split; its random streams are of two
kinds, and ``install()`` wraps the seams of both:

- **torch generators.** Producers: ``torch.Generator(...).manual_seed``
  (``torch.Generator`` is replaced by a subclass whose ``manual_seed``
  registers) and ``torch.manual_seed`` (the default CPU generator). Each
  registers the generator's state after seeding as a fresh *generation*,
  keyed by a digest of ``get_state()``. Consumers: torch's samplers
  handed a ``generator=`` (:data:`CONSUMERS`: ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``multinomial``, ``bernoulli``, and
  ``Tensor.normal_``, ``uniform_``, ``bernoulli_``, ``exponential_``),
  each recording a consumption of the state it begins from. A draw advances the state, so two draws begin from one state
  only when the state was put back or a second generator was seeded
  alike.
- **counter keys.** A draw of ``ops/random.py`` is a pure function of
  its key: ``DropoutKey(seed, counter, stream)`` for the layers'
  dropout masks (``uniform_bits``), ``(base, seed, position)`` a row for
  the sampler's Gumbel noise (``models/transformer.py`` ``gumbel_noise``).
  Building a ``DropoutKey`` registers a fresh generation; each
  ``uniform_bits`` call and each row of a ``gumbel_noise`` call consumes
  one.

A violation is one generation consumed at two different **consumer
sites**: the two draws are the same numbers (for the same sampler and
shape) or correlated, at two places that mean to draw independently. A
consumer site is the innermost in-repo frame outside this module and
outside the draws' own plumbing (``ops/random.py``, and
``TransformerLM._gumbel``, the sampler's seam), so all dropout masks do
not collapse onto one line. Drawing one generation again at the SAME
site is not a violation: a remat recomputation (``torch.utils.
checkpoint``) and a reverted step's retry draw the same mask on purpose.
The report carries both consumptions' stacks and the creation site.

Generation semantics keep the deliberate same-bits flows clean, as in
the reference: seeding again with the same seed (``manual_seed``), or
building a ``DropoutKey`` again at the same counter value, re-registers
the state as a fresh generation with no consumption, so parity tests
that build two models from one seed never trip the gate.

Enablement is the registered ``DL4J_TORCH_RNGWATCH`` knob (default OFF:
reading a generator's state or a device counter syncs the card, a
test-lane cost), which the pytest plugin ``testing/pytest_watch.py``
honours. ``tests/conftest.py`` installs only the JAX package's
watchers, so the port's own tests and ``chip_smoke.py``'s phase
``watch`` install this one explicitly.

Scope limits:

- **draws during a CUDA-graph capture are skipped.** Reading a counter
  or a CUDA generator's state inside a capture
  (``torch.cuda.is_current_stream_capturing()``) syncs the stream, which
  raises "operation not permitted when stream is capturing"; the
  counterpart of the reference skipping traced code. A replayed graph
  calls no Python, so its draws are not seen either: on the card the
  watcher sees the eager runs (per-batch steps, a StaticGraph's first,
  uncaptured call, the fused loop's warm-up) and the host's draws;
- draws from the implicit default generator (no ``generator=``) are not
  watched; the port's code draws through explicit generators;
- bindings taken before ``install()`` (``from torch import rand``)
  bypass the module-attribute wraps; the port's idiom is attribute
  calls. Generators created before ``install()`` register lazily at
  their first watched draw, with an ``<unobserved>`` creation site.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
from contextlib import contextmanager

__all__ = ["enabled", "install", "uninstall", "installed", "watch",
           "snapshot", "generations", "observed_sites", "consumptions",
           "skipped", "violations", "reset", "report", "assert_clean",
           "PRODUCERS", "CONSUMERS"]

# the seam vocabulary: producers register a generation, consumers draw
PRODUCERS = ("torch.Generator.manual_seed", "torch.manual_seed",
             "ops.random.DropoutKey")
_TORCH_SAMPLERS = ("rand", "randn", "randint", "randperm", "multinomial",
                   "bernoulli")
_TENSOR_SAMPLERS = ("normal_", "uniform_", "bernoulli_", "exponential_")
CONSUMERS = tuple(f"torch.{n}" for n in _TORCH_SAMPLERS) + tuple(
    f"torch.Tensor.{n}" for n in _TENSOR_SAMPLERS) + (
    "ops.random.uniform_bits", "models.transformer.gumbel_noise")

_state = threading.RLock()
_gens: dict = {}               # fingerprint -> _Generation
_violations: list = []
_observed: dict = {}           # (abspath, lineno) -> kind
_serial = [0]                  # violation serial (snapshot marker)
_skipped = [0]                 # draws skipped inside a capture
_consumed = [0]                # draws recorded
_installed = False
_originals: dict = {}          # (owner, name) -> the unwrapped attribute

_MAX_FRAMES = 12

# repo root: the parent of the deeplearning4j_tpu_torch package — only
# frames under it attribute (the same anchoring as leakwatch)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PKG = os.path.join(_REPO_ROOT, "deeplearning4j_tpu_torch")
# the draws' own plumbing: never a consumer site
_PLUMBING = {os.path.join(_PKG, "ops", "random.py"): None,
             os.path.join(_PKG, "models", "transformer.py"): "_gumbel"}


def enabled():
    """Whether the registered ``DL4J_TORCH_RNGWATCH`` knob asks for the
    watcher (read at call time; default off)."""
    from deeplearning4j_tpu_torch.config import env_flag
    return env_flag("DL4J_TORCH_RNGWATCH")


class _Generation:
    """One registered stream state: where it was minted and every
    consumption since."""

    __slots__ = ("site", "op", "consumptions")

    def __init__(self, site, op):
        self.site = site               # (abspath, lineno) or None
        self.op = op                   # producing op name
        self.consumptions = []         # [(op, site, frames)]


def _repo_frames():
    """In-repo ``(abspath, lineno)`` frames, innermost first, skipping
    this module and the draws' plumbing."""
    out = []
    f = sys._getframe(2)
    while f is not None and len(out) < _MAX_FRAMES:
        name = f.f_code.co_filename
        if name != __file__ and not name.startswith("<"):
            ap = os.path.abspath(name)
            if ap in _PLUMBING and _PLUMBING[ap] in (None, f.f_code.co_name):
                f = f.f_back
                continue
            if ap.startswith(_REPO_ROOT + os.sep) and \
                    "site-packages" not in ap:
                out.append((ap, f.f_lineno))
        f = f.f_back
    return out


def _capturing():
    import torch
    try:
        return torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing()
    except RuntimeError:
        return False


def _skip():
    """Whether a draw must be skipped (a capture is under way); counts
    it."""
    if _capturing():
        with _state:
            _skipped[0] += 1
        return True
    return False


def _gen_fingerprint(gen):
    state = gen.get_state()
    digest = hashlib.blake2b(bytes(state.numpy().tobytes()),
                             digest_size=16).hexdigest()
    return ("generator", str(gen.device), digest)


def _key_fingerprint(key):
    return ("counter", key.seed, int(key.counter), key.stream)


def _register(fp, op, site):
    with _state:
        _gens[fp] = _Generation(site, op)
        if site is not None:
            _observed[site] = "create"


def _consume(fp, op, site, frames):
    with _state:
        _consumed[0] += 1
        gen = _gens.get(fp)
        if gen is None:
            gen = _gens[fp] = _Generation(None, "<unobserved>")
        if site is not None:
            _observed.setdefault(site, "consume:" + op)
        if any(c[1] != site for c in gen.consumptions) and not any(
                v["generation"] is gen for v in _violations):
            first = next(c for c in gen.consumptions if c[1] != site)
            _serial[0] += 1
            _violations.append({
                "serial": _serial[0], "generation": gen,
                "created": gen.site, "created_by": gen.op,
                "first": first, "second": (op, site, frames)})
        gen.consumptions.append((op, site, frames))


def _site(frames):
    return frames[0] if frames else None


# ---- the wrapped seams -----------------------------------------------------

def _make_generator_cls(base):
    class Generator(base):
        def manual_seed(self, seed):
            out = base.manual_seed(self, seed)
            if not _skip():
                frames = _repo_frames()
                _register(_gen_fingerprint(self), "manual_seed",
                          _site(frames))
            return out
    Generator.__qualname__ = base.__qualname__
    Generator.__module__ = base.__module__
    return Generator


def _wrap_torch_manual_seed(fn):
    def manual_seed(seed):
        import torch
        out = fn(seed)
        if not _skip():
            frames = _repo_frames()
            _register(_gen_fingerprint(torch.default_generator),
                      "manual_seed", _site(frames))
        return out
    manual_seed.__wrapped__ = fn
    return manual_seed


def _wrap_sampler(name, fn):
    def sampler(*args, **kwargs):
        gen = kwargs.get("generator")
        if gen is not None and not _skip():
            frames = _repo_frames()
            _consume(_gen_fingerprint(gen), name, _site(frames), frames)
        return fn(*args, **kwargs)
    sampler.__name__ = getattr(fn, "__name__", name)
    sampler.__wrapped__ = fn
    return sampler


def _wrap_key_init(fn):
    def __init__(self, seed, counter, stream):
        fn(self, seed, counter, stream)
        if not _skip():
            frames = _repo_frames()
            _register(_key_fingerprint(self), "DropoutKey", _site(frames))
    __init__.__wrapped__ = fn
    return __init__


def _wrap_uniform_bits(fn):
    def uniform_bits(key, n, device):
        if not _skip():
            frames = _repo_frames()
            _consume(_key_fingerprint(key), "uniform_bits", _site(frames),
                     frames)
        return fn(key, n, device)
    uniform_bits.__wrapped__ = fn
    return uniform_bits


def _wrap_gumbel(fn):
    def gumbel_noise(base, seeds, pos, vocab):
        if not _skip():
            frames = _repo_frames()
            site = _site(frames)
            b = int(base)
            rows = set(zip(seeds.tolist(), pos.tolist()))
            for seed, p in sorted(rows):
                _consume(("gumbel", b, seed, p), "gumbel_noise", site,
                         frames)
        return fn(base, seeds, pos, vocab)
    gumbel_noise.__wrapped__ = fn
    return gumbel_noise


def installed():
    return _installed


def _patch(owner, name, wrapper):
    # None: the attribute was inherited (a Tensor method of TensorBase),
    # so uninstall() deletes the wrapper instead of pinning a copy
    _originals[(owner, name)] = vars(owner).get(name)
    setattr(owner, name, wrapper)


def install():
    """Wrap the producer and consumer seams. Idempotent."""
    global _installed
    with _state:
        if _installed:
            return
        import torch
        from deeplearning4j_tpu_torch.models import transformer
        from deeplearning4j_tpu_torch.ops import random as random_mod
        _patch(torch, "Generator", _make_generator_cls(torch.Generator))
        _patch(torch, "manual_seed",
               _wrap_torch_manual_seed(torch.manual_seed))
        for name in _TORCH_SAMPLERS:
            _patch(torch, name, _wrap_sampler(name, getattr(torch, name)))
        for name in _TENSOR_SAMPLERS:
            _patch(torch.Tensor, name,
                   _wrap_sampler(name, getattr(torch.Tensor, name)))
        _patch(random_mod.DropoutKey, "__init__",
               _wrap_key_init(random_mod.DropoutKey.__init__))
        _patch(random_mod, "uniform_bits",
               _wrap_uniform_bits(random_mod.uniform_bits))
        _patch(transformer, "gumbel_noise",
               _wrap_gumbel(transformer.gumbel_noise))
        _installed = True


def uninstall():
    """Restore the unwrapped seams and stop recording. Generators made
    while installed keep working (and keep registering their seeds)."""
    global _installed
    with _state:
        if not _installed:
            return
        for (owner, name), fn in _originals.items():
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)
        _originals.clear()
        _installed = False


@contextmanager
def watch():
    """``with rngwatch.watch():`` wraps for the block; on exit it
    restores ONLY if this block did the installing."""
    already = _installed
    install()
    try:
        yield sys.modules[__name__]
    finally:
        if not already:
            uninstall()


# ---- query surfaces --------------------------------------------------------

def snapshot():
    """An opaque marker: pass to the gate functions to scope them to
    violations recorded AFTER this point."""
    with _state:
        return _serial[0]


def generations():
    """``{fingerprint: (creation site or None, consumption count)}``."""
    with _state:
        return {fp: (g.site, len(g.consumptions))
                for fp, g in _gens.items()}


def observed_sites():
    """``{(abspath, lineno): kind}`` of every in-repo site that produced
    or consumed a stream."""
    with _state:
        return dict(_observed)


def consumptions():
    """Total consumptions recorded (draws outside a capture) since the
    last :func:`reset`."""
    with _state:
        return _consumed[0]


def skipped():
    """Draws skipped because a CUDA-graph capture was under way."""
    with _state:
        return _skipped[0]


def violations(since=0):
    with _state:
        return [v for v in _violations if v["serial"] > since]


def reset():
    """Drop the books and recorded violations."""
    with _state:
        _gens.clear()
        _violations.clear()
        _observed.clear()
        _skipped[0] = 0
        _consumed[0] = 0


def _fmt_site(site):
    if site is None:
        return "<out of repo>"
    return f"{os.path.relpath(site[0], _REPO_ROOT)}:{site[1]}"


def report(since=0):
    bad = violations(since)
    if not bad:
        return "rngwatch: no stream drawn twice"
    out = [f"rngwatch: {len(bad)} stream state(s) drawn at two sites"]
    for v in bad:
        created = (_fmt_site(v["created"]) if v["created"] is not None
                   else "<unobserved>")
        out.append(f"  - state from {v['created_by']} at {created}:")
        for tag, (op, _site, frames) in (("first", v["first"]),
                                         ("second", v["second"])):
            where = " <- ".join(_fmt_site(s) for s in frames[:4]) \
                or "<out of repo>"
            out.append(f"      {tag} draw: {op} at {where}")
    out.append("one stream state feeds one draw site: keep drawing from the "
               "generator (never put its state back for another sampler), "
               "give each consumer its own generator or key stream, or "
               "advance the draw counter between uses")
    return "\n".join(out)


def assert_clean(since=0):
    """Raise ``AssertionError`` for every stream drawn at two sites since
    the marker. Violations are recorded at draw time, so a swallowed
    failure still shows at a later gate."""
    if violations(since):
        raise AssertionError(report(since))
