"""The port's public surface against the JAX package's: every public name
that a ``repro.*`` module defines (its top-level functions, classes and
assignments; for a package's ``__init__`` also what it re-exports) exists
in the ``repro_torch`` module of the same path, but for the departures
listed here with their reasons.  Then the two names whose values are
compared: ``list_archs`` and ``batch_specs``."""
import ast
import importlib
import pkgutil

import pytest

import repro
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import list_archs as jax_list_archs
from repro.core.types import MeshConfig as JaxMeshConfig
from repro.parallel import batch_specs as jax_batch_specs
from repro_torch.configs import ARCHS, list_archs
from repro_torch.core.types import MeshConfig
from repro_torch.parallel import batch_specs

_PALLAS = "a Pallas kernel: the port's is a CUDA source under csrc/, " \
          "launched by the ops module"
# module -> the reason it has no counterpart
MODULE_DEPARTURES = {f"repro.kernels.{k}.kernel": _PALLAS
                     for k in ("compress", "flash_attention", "moe_gmm",
                               "ssd_scan")}
_TPU = "the TPU's interconnect and core; the port's hw describes the " \
       "H100 (HBM_BW, NVLINK_BW)"
# (module, name) -> the reason the port's module does not define it
NAME_DEPARTURES = {
    ("repro.launch.analysis", "parse_collectives"):
        "reads XLA's HLO text; the port has no HLO and records its "
        "collectives as they run (record_collectives)",
    ("repro.launch.mesh", "make_production_mesh"):
        "builds a jax Mesh; the port's mesh is a world of processes "
        "(production_world) and its groups (mesh_groups)",
    ("repro.launch.mesh", "make_smoke_mesh"):
        "builds a jax Mesh; the port's smoke mesh is smoke_mesh_config "
        "on one process",
    ("repro.kernels.compress.ref", "wire_codec"):
        "lives in kernels.compress.ops, which takes K2a/K2b on CUDA "
        "tensors and their plain versions on the host",
    **{("repro.core.hw", n): _TPU for n in (
        "ICI_BW_PER_LINK", "ICI_LINKS_PER_CHIP", "DCN_BW_PER_HOST",
        "VMEM_BYTES", "MXU_TILE")},
}


def _modules():
    return ["repro"] + sorted(m.name for m in pkgutil.walk_packages(
        repro.__path__, "repro."))


def _defined(mod) -> list:
    """The public names ``mod``'s source defines at top level, and for a
    package's ``__init__`` the names it imports from the package."""
    init = mod.__file__.endswith("__init__.py")
    names = []
    for node in ast.parse(open(mod.__file__).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif init and isinstance(node, ast.ImportFrom) and \
                (node.module or "").startswith("repro"):
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


@pytest.mark.parametrize("name", _modules())
def test_every_public_name_has_its_counterpart(name):
    """The port's module of the same path holds every public name the
    JAX package's defines, but the listed departures, which the port
    indeed lacks (the list stays true)."""
    mod = importlib.import_module(name)
    port = "repro_torch" + name[len("repro"):]
    if name in MODULE_DEPARTURES:
        with pytest.raises(ImportError):
            importlib.import_module(port)
        return
    twin = importlib.import_module(port)
    for n in _defined(mod):
        if (name, n) in NAME_DEPARTURES:
            assert not hasattr(twin, n), (name, n)
        else:
            assert hasattr(twin, n), f"{port} lacks {n} of {name}"


def test_departures_name_what_the_reference_defines():
    """Each departure is a name the JAX package's module defines."""
    for (name, n) in NAME_DEPARTURES:
        assert n in _defined(importlib.import_module(name)), (name, n)
    for name in MODULE_DEPARTURES:
        assert "pallas_call" in open(importlib.import_module(
            name).__file__).read()


def test_list_archs():
    assert list_archs() == ARCHS == jax_list_archs() == JAX_ARCHS
    assert list_archs() is not ARCHS


@pytest.mark.parametrize("shape,names,data", [
    ((4, 1), ("data", "model"), ("data",)),
    ((2, 2), ("data", "model"), ("data",)),
    ((2, 16, 16), ("pod", "data", "model"), ("pod", "data"))])
def test_batch_specs_are_the_references(shape, names, data):
    """``batch_specs`` is the JAX package's dict, each ``PartitionSpec``
    as the port's tuple of axes."""
    want = jax_batch_specs(JaxMeshConfig(shape=shape, axis_names=names,
                                         data_axes=data))
    got = batch_specs(MeshConfig(shape=shape, axis_names=names,
                                 data_axes=data))
    assert got == {k: tuple(v) for k, v in want.items()}
