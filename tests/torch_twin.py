"""Helpers of the twin tests of the port's planning layers
(``tests/test_torch_{demand,net,sched,ccl_model,synth,obs}.py``).

A twin test builds the same thing in both packages with one function of a
package root, ``build(pkg)``, where ``pkg.ccl.select`` is
``repro.ccl.select`` on one side and ``repro_torch.ccl.select`` on the
other, and holds the two results equal through ``canon``: dataclasses by
type name and fields, dicts in their iteration order, tuples and lists by
kind, sets as sets, topologies by their wiring.  So the port must build
the reference's values in the reference's order, to the last bit.
"""
import dataclasses
import importlib
import math
import types


class Pkg:
    """Attribute access to a package's modules: ``Pkg("repro").ccl.select``
    imports and returns (a view of) ``repro.ccl.select``."""

    def __init__(self, dotted: str):
        self._dotted = dotted
        self._mod = importlib.import_module(dotted)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        value = getattr(self._mod, name, None)
        if value is None or isinstance(value, types.ModuleType):
            try:
                return Pkg(f"{self._dotted}.{name}")
            except ModuleNotFoundError:
                if value is None:
                    raise AttributeError(f"{self._dotted}.{name}") from None
        return value


REF = Pkg("repro")
PORT = Pkg("repro_torch")


_SCALARS = (int, str, bool, type(None))
_FIELDS: dict = {}


def _field_names(cls):
    names = _FIELDS.get(cls)
    if names is None:
        names = _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
    return names


def canon(x):
    """A comparable, package-free form of ``x`` (see the module doc)."""
    if isinstance(x, _SCALARS):
        return x
    if isinstance(x, float):
        return ("nan",) if math.isnan(x) else x
    cls = type(x)
    if cls.__name__ == "Topology":
        edges = [(u, v, tuple(sorted(d.items())))
                 for u, v, d in x.graph.edges(data=True)]
        return ("Topology", x.name, tuple(x.accelerators), tuple(x.hosts),
                tuple(x.graph.nodes), tuple(edges))
    if dataclasses.is_dataclass(cls):
        return (cls.__name__,) + tuple(
            (name, canon(getattr(x, name))) for name in _field_names(cls))
    if isinstance(x, dict):
        return ("dict",) + tuple((canon(k), canon(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (cls.__name__,) + tuple(canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set", frozenset(canon(v) for v in x))
    if cls.__name__ in ("Fixed", "Choice", "Search"):
        return (cls.__name__, repr(x))
    return x


def twin(build):
    """``(build(REF), build(PORT))``."""
    return build(REF), build(PORT)


def same(build):
    """Build in both packages, assert the results equal under ``canon``,
    and return the reference's and the port's."""
    ref, port = twin(build)
    assert canon(port) == canon(ref)
    return ref, port


def same_raises(build, exc_name: str):
    """Both packages raise an exception of the class named ``exc_name``
    with the same message."""
    msgs = []
    for pkg in (REF, PORT):
        try:
            build(pkg)
        except Exception as e:  # noqa: BLE001 - compared by name below
            assert type(e).__name__ == exc_name, (pkg._dotted, repr(e))
            msgs.append(str(e))
        else:
            raise AssertionError(f"{pkg._dotted} did not raise {exc_name}")
    assert msgs[0] == msgs[1]
