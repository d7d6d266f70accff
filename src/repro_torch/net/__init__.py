"""Network layer (paper Sec. II-D / III-C): topologies + flow simulation.

The port's copy of ``repro.net``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from repro_torch.net.topology import Topology  # noqa: F401
from repro_torch.net.simulate import (simulate_flowset,  # noqa: F401
                                      simulate_schedule)
