"""Typed knobs of a cross-layer plan space.

The co-design surface (paper Sec. IV-A) is one joint design space —
placement, per-primitive algorithm, codec budget, scheduling policy,
switch capacity — not a flat keyword list.  A knob declares how much of
that space a caller opens up:

  * :class:`Fixed`  — the knob is pinned to one value (``plan()`` accepts
    only fully-pinned scalar knobs);
  * :class:`Choice` — a finite candidate set for ``search()`` to
    enumerate (or, for the per-primitive algorithm knob, a whitelist the
    selection layer prices as-is);
  * :class:`Search` — an open knob whose candidates come from a
    generator (placement search) or from the selection layer's own
    candidate registry (algorithms).

Knobs live in ``repro_torch.core`` because both ends of the stack read them:
``codesign.api`` walks them top-down, ``ccl.select`` receives them as
per-task constraints instead of ad-hoc ``allow``/``force`` arguments.

The port's copy of ``repro.core.knobs``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

from typing import Any, Tuple


class Knob:
    """Base class; use :class:`Fixed`, :class:`Choice` or :class:`Search`."""

    __slots__ = ()


class Fixed(Knob):
    """The knob is pinned: ``plan()`` uses ``value`` verbatim.  For the
    per-primitive algorithm knob this is a *force* — it bypasses the
    error-budget gate exactly like a single-name ``allow`` did."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        object.__setattr__(self, "value", value)

    def __setattr__(self, *_):
        raise AttributeError("Fixed is immutable")

    def __repr__(self):
        return f"Fixed({self.value!r})"

    def __eq__(self, other):
        return isinstance(other, Fixed) and self.value == other.value

    def __hash__(self):
        # unhashable values (e.g. a primitive -> budget dict) all share
        # the type's hash: collisions are fine, equal-objects-unequal-
        # hashes would not be (repr() is insertion-order dependent)
        try:
            return hash(("Fixed", self.value))
        except TypeError:
            return hash("Fixed")


class Choice(Knob):
    """A finite candidate set: ``search()`` enumerates the options in the
    given order (the first option is the knob's attribution baseline);
    as an algorithm constraint it is a whitelist that still respects the
    error budget."""

    __slots__ = ("options",)

    def __init__(self, *options: Any):
        if not options:
            raise ValueError("Choice needs at least one option")
        object.__setattr__(self, "options", tuple(options))

    def __setattr__(self, *_):
        raise AttributeError("Choice is immutable")

    def __repr__(self):
        return f"Choice{self.options!r}"

    def __eq__(self, other):
        return isinstance(other, Choice) and self.options == other.options

    def __hash__(self):
        try:
            return hash(("Choice", self.options))
        except TypeError:
            return hash("Choice")  # see Fixed.__hash__


class Search(Knob):
    """An open knob: candidates come from an optimizer — placement pulls
    heuristics + a hill climb (``codesign.placement_search``),
    ``bucket_bytes``/``stagger`` generate deterministic ladders/grids,
    and ``synthesize`` opens the SCCL/TACCL-style schedule synthesizer
    (``ccl.synth``) as a priced candidate next to the registry; as an
    algorithm constraint it means "every registered candidate", i.e. the
    selection layer's default.  ``seeds`` lets the caller inject extra
    starting candidates (e.g. hand-built Placements) — and
    ``search(problem, seeds_dir=...)`` persists each run's winner as a
    warm start for the next (``codesign.seeds``)."""

    __slots__ = ("seeds",)

    def __init__(self, *, seeds: Tuple[Any, ...] = ()):
        object.__setattr__(self, "seeds", tuple(seeds))

    def __setattr__(self, *_):
        raise AttributeError("Search is immutable")

    def __repr__(self):
        return f"Search(seeds={self.seeds!r})" if self.seeds else "Search()"

    def __eq__(self, other):
        return isinstance(other, Search) and self.seeds == other.seeds

    def __hash__(self):
        try:
            return hash(("Search", self.seeds))
        except TypeError:
            return hash("Search")  # see Fixed.__hash__


def as_knob(value: Any) -> Knob:
    """Coerce a raw value into a knob (raw = pinned)."""
    return value if isinstance(value, Knob) else Fixed(value)


def is_free(knob: Knob) -> bool:
    """Free knobs are what ``search()`` walks; Fixed ones are pinned."""
    return isinstance(knob, (Choice, Search))
