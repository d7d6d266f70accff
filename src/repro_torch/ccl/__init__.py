"""Collective Communication Library layer of the port (paper Sec. II-C /
III-B), copied from ``repro.ccl`` without JAX.

  * ``algorithms``  — collective algorithms as explicit flow schedules
                      (ring, bidirectional ring, recursive halving/doubling,
                      tree, direct all-to-all) usable by the network
                      simulator, plus compressed candidates (``ring+q8``,
                      ``ps+topk``, ...) wrapping any base schedule with a
                      codec's wire-byte ratio
  * ``primitives``  — the same algorithms as executable collectives on
                      ``torch.distributed`` — including the quantized
                      compressed ring and the move-list interpreter of
                      synthesized schedules
  * ``cost``        — alpha-beta cost models; ``select`` does NCCL-style
                      auto-selection (with an ``error_budget`` gate for
                      lossy candidates); ``synth`` does TACCL-style
                      sketch-guided synthesis on an arbitrary topology
"""
from repro_torch.ccl.algorithms import (ALGORITHMS,  # noqa: F401
                                        COMPRESSED_CANDIDATES, generate_flows)
from repro_torch.ccl.cost import algo_cost, CostParams  # noqa: F401
from repro_torch.ccl.select import (AlphaBeta, CostModel,  # noqa: F401
                                    FlowSim, Selection, select_algorithm,
                                    select_for_task)
