"""Common codec API for gradient compression (paper Sec. II-A lever 3).

Port of ``repro.compress.codec`` without JAX.  The parallelization-strategy
layer can shrink the exposed-communication term by sending *less* instead
of sending *faster*: quantization, sparsification and low-rank
factorization.  This module defines the layer interface:

  * :class:`CodecSpec`  — the *static* contract a codec makes with the
    pricing layers: wire-byte ratio, nominal relative error, whether an
    error-feedback residual compensates across steps, and how many
    full-payload memory passes encode+decode cost (plain numbers, equal to
    the JAX package's).
  * :class:`Codec`      — the executable face: ``encode(x, state) ->
    (Encoded, state)`` / ``decode(Encoded) -> x`` on tensors (``Encoded`` is
    a plain dataclass of tensors), with the error-feedback residual handled
    generically in the base class.  Random draws take a ``torch.Generator``
    (``generator=``) where the JAX package takes a key.
  * a registry (``get_codec`` / ``codec_spec``) plus the
    ``"<algorithm>+<codec>"`` naming convention (``split_algorithm`` /
    ``base_algorithm``) of compressed collective candidates such as
    ``ring+q8`` and ``ps+topk``.

Concrete codecs live in :mod:`repro_torch.compress.quant` (int8/int4
quantization through the K2a/K2b kernels), :mod:`repro_torch.compress.topk`
(magnitude sparsification with error feedback) and
:mod:`repro_torch.compress.lowrank` (PowerSGD through the K4 kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class CodecSpec:
    """The static contract between a codec and the pricing layers.

    ``wire_ratio``  — wire bytes emitted per fp32 payload byte (< 1).
    ``rel_error``   — nominal single-shot relative L2 error, the number the
                      selection layer's ``error_budget`` knob is compared
                      against (a documented modeling constant, not a bound).
    ``error_feedback`` — the codec keeps a residual state that re-injects
                      the compression error into the next step, halving the
                      *effective* long-run error (see ``effective_error``).
    ``passes``      — full-payload memory passes encode+decode cost, the
                      compute-overhead term of the cost models.
    """

    name: str
    wire_ratio: float
    rel_error: float
    error_feedback: bool = False
    passes: float = 2.0

    @property
    def effective_error(self) -> float:
        """What selection compares against the error budget: codecs with an
        error-feedback residual are charged half their single-shot error
        (the residual provably re-injects what one step dropped)."""
        return self.rel_error * (0.5 if self.error_feedback else 1.0)


# ---------------------------------------------------------------------------
# "<base>+<codec>" naming convention for compressed collective candidates
# ---------------------------------------------------------------------------


def split_algorithm(name: str) -> Tuple[str, Optional[str]]:
    """``"ring+q8" -> ("ring", "q8")``; plain names get ``(name, None)``."""
    if "+" in name:
        base, codec = name.split("+", 1)
        return base, codec
    return name, None


def base_algorithm(name: str) -> str:
    """The underlying collective algorithm a candidate name resolves to.
    ``ps`` (parameter-server) is an alias for the ``atp`` flow pattern —
    the compressed PS candidates push sparse gradients through the same
    worker->ps->worker schedule."""
    base, _ = split_algorithm(name)
    return "atp" if base == "ps" else base


# ---------------------------------------------------------------------------
# Executable codecs
# ---------------------------------------------------------------------------


@dataclass
class Encoded:
    """A compressed payload: the wire tensors plus what decode needs."""

    codec: str
    shape: Tuple[int, ...]
    dtype: Any
    arrays: Tuple[torch.Tensor, ...]
    wire_bytes: int = 0


class Codec:
    """Base class: error feedback handled generically.

    Subclasses implement ``_encode(x, generator)`` (compress, no residual
    logic) and ``decode(enc)``.  ``encode`` folds the carried residual into
    the input first and returns the new residual, so a caller's loop is::

        state = codec.init_state(grad)
        for step ...:
            enc, state = codec.encode(grad, state)
            send(enc.arrays); ...
    """

    spec: CodecSpec

    def init_state(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Zero residual for error-feedback codecs, else ``None``."""
        if not self.spec.error_feedback:
            return None
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    def encode(self, x: torch.Tensor, state: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Compress ``x`` (+ carried residual) -> ``(Encoded, new_state)``."""
        if self.spec.error_feedback and state is not None:
            y = x.to(state.dtype) + state
        else:
            y = x
        enc = self._encode(y, generator=generator)
        if self.spec.error_feedback:
            new_state = y - self.decode(enc).to(y.dtype)
            return enc, new_state
        return enc, state

    def _encode(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Encoded:
        raise NotImplementedError

    def decode(self, enc: Encoded) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, size_bytes: int) -> int:
        """Static wire-byte estimate for an fp32 payload of ``size_bytes``."""
        return max(int(size_bytes * self.spec.wire_ratio), 1)

    def roundtrip(self, x: torch.Tensor, state: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        """encode+decode in one call (what a compressed collective applies
        per hop); returns ``(decoded, new_state)``."""
        enc, state = self.encode(x, state=state, generator=generator)
        return self.decode(enc), state


# ---------------------------------------------------------------------------
# Registry.  Specs are static; instances are built lazily.
# ---------------------------------------------------------------------------

# Nominal spec constants (modeling choices, the JAX package's own):
#   q8 / q4   — wire_ratio = bits/32 (+ one fp32 scale, amortized away);
#               rel_error ~ half an int step relative to absmax.
#   topk      — keep the top 5% magnitudes; values + int32 indices on the
#               wire (2 * fraction); single-shot error ~ sqrt(1 - fraction)
#               of the payload norm, compensated by error feedback.
#   lowrank   — PowerSGD rank-4: (m+n)*r vs m*n words; passes charged for
#               the two projections + orthonormalization.
SPECS: Dict[str, CodecSpec] = {
    "q8": CodecSpec("q8", wire_ratio=8 / 32, rel_error=0.006,
                    error_feedback=False, passes=2.0),
    "q4": CodecSpec("q4", wire_ratio=4 / 32, rel_error=0.09,
                    error_feedback=False, passes=2.0),
    "topk": CodecSpec("topk", wire_ratio=2 * 0.05, rel_error=0.97,
                      error_feedback=True, passes=3.0),
    "lowrank": CodecSpec("lowrank", wire_ratio=0.06, rel_error=0.7,
                         error_feedback=True, passes=6.0),
}

_FACTORIES: Dict[str, Callable[[], "Codec"]] = {}
_INSTANCES: Dict[str, "Codec"] = {}


def register_codec(spec: CodecSpec, factory: Callable[[], Codec]) -> None:
    SPECS[spec.name] = spec
    _FACTORIES[spec.name] = factory
    _INSTANCES.pop(spec.name, None)


def codec_spec(name: str) -> CodecSpec:
    """Static pricing spec for ``name``."""
    try:
        return SPECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; registered: {list(SPECS)}")


def _default_factory(name: str) -> Codec:
    if name in ("q8", "q4"):
        from repro_torch.compress.quant import QuantCodec

        return QuantCodec(bits=8 if name == "q8" else 4)
    if name == "topk":
        from repro_torch.compress.topk import TopKCodec

        return TopKCodec(fraction=0.05)
    if name == "lowrank":
        from repro_torch.compress.lowrank import LowRankCodec

        return LowRankCodec(rank=4)
    raise KeyError(f"unknown codec {name!r}; registered: {list(SPECS)}")


def get_codec(name: str) -> Codec:
    """Executable codec instance for ``name`` (cached)."""
    if name not in _INSTANCES:
        factory = _FACTORIES.get(name)
        _INSTANCES[name] = factory() if factory else _default_factory(name)
    return _INSTANCES[name]
