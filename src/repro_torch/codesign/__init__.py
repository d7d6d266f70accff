"""Cross-layer co-design engine (paper Sec. II-E / IV-A).

The survey's central observation is that the three layers of the training
communication stack — parallelization strategy, collective communication
library, and network — are "relatively independent", and that *vertical
co-design* across them is the open opportunity.  This package wires them
together behind one declarative surface:

``api``
    :class:`CodesignProblem` = model/shape/mesh/topology plus a
    :class:`PlanSpace` of typed knobs (``repro_torch.core.knobs``): placement,
    per-primitive algorithm, codec error budget, scheduling policy,
    switch capacity — each ``Fixed(v)``, ``Choice(...)`` or
    ``Search()``.  ``plan(problem)`` prices one fully pinned point of
    the space into a :class:`CodesignReport`; ``search(problem,
    budget=N)`` walks the free knobs with one shared memoized cost model
    and returns a :class:`SearchResult` (best plan, explored frontier,
    per-knob attribution of the win).  Both reports serialize to JSON
    (``to_dict``/``from_dict``) so plans can be persisted.

``placement``
    Maps logical mesh coordinates (``core.types.MeshConfig``) onto the
    physical accelerators of a ``net.Topology`` so every ``CommTask.group``
    names real devices.  Conventions:

    * Logical global ranks are **row-major** over ``MeshConfig.shape``
      with the **model axis innermost** (the MeshConfig default), so
      ``packed`` placement puts each TP communicator on consecutive
      physical devices — one host, on DGX/fat-tree topologies.
    * ``strided`` round-robins ranks across hosts (the anti-pattern
      baseline); ``custom`` takes an explicit rank -> device tuple.
    * The demand builder emits one *representative* communicator per mesh
      axis (all replicas run the same collective concurrently);
      ``CommTask.axis`` ("model" / "data") tells placement which axis a
      group spans, and ``replica=`` selects which concrete communicator
      stands in for it.

``placement_search``
    The ROADMAP's TopoOpt-style optimizer behind ``placement=Search()``:
    deterministic heuristic candidates (packed, host-balanced, strided,
    axis permutations) plus a hot-spot-guided swap-neighborhood hill
    climb.  The host-balanced family is the headline: where ``packed``
    straddles a host boundary unevenly (TP-12 over 8-GPU hosts = 8+4),
    the even split restores the equal-size partition the hierarchical
    decomposition needs, and search finds it.

``driver``
    The legacy keyword surface: ``plan_iteration(cfg, shape, mesh, topo,
    ...)`` is an exact kwarg-for-kwarg adapter over
    ``plan(CodesignProblem.from_kwargs(...))``.

``cluster``
    The "Horizontal" arrow: ``plan_cluster(jobs, topo)`` runs every
    tenant's pinned problem (``JobSpec`` either carries a
    ``CodesignProblem`` or the legacy flat fields) through ``plan``,
    asks the network layer which links carry >= 2 jobs' traffic,
    compresses each job into a ``sched.flows`` ``JobProfile`` and
    CASSINI-staggers their iteration phases, returning a
    ``ClusterReport`` (naive vs. staggered per-job JCT, contended links,
    chosen phases).

``serving``
    The inference half of the story: ``ServingSpec`` (model +
    prefill/decode disaggregation + SLO + an open-loop
    ``sched.arrivals`` process) turns ``CodesignProblem`` into a
    serving problem.  ``plan_serving`` prices the prefill batch graph,
    the per-rank KV-cache ``p2p`` hand-off, and the one-token decode
    step through the same CCL/network layers, then replays the arrival
    process through a deterministic queueing simulation with co-tenant
    training pulses contending on shared links.  ``ServingReport``
    speaks TTFT/TPOT percentiles + goodput, registered in the shared
    objective metric registry, so ``search()`` over a ``stagger`` or
    ``placement`` knob returns SLO-feasible serving plans.

``dynamics``
    The cluster as a moving target: ``ClusterDynamics`` consumes a trace
    of ``Event``s (job arrival/departure, link failure/degradation, host
    failure, stragglers) over degradation views of the topology and
    re-plans *incrementally* — vertical re-plans only for jobs whose
    routes the event touched, phase re-search only over the dirty jobs
    (``restagger_cluster``), full ``plan_cluster`` re-search as the
    infeasibility fallback.  Warm-starts from a persisted
    ``ClusterReport``; ``DynamicsReport`` records per-event
    time-to-replan and regret vs. a full re-search.

"Host-Net" in-network aggregation is a first-class selection candidate:
``sched.atp`` exposes the aggregation capability (with the multi-tenant
switch-memory fallback) and both cost models price the ``atp`` all-reduce
against ``hierarchical`` and friends on switched topologies.

So is gradient compression (``repro_torch.compress``): an ``error_budget``
knob admits lossy candidates (``ring+q8``, ``ps+topk``, ...) into
per-task selection — a float for every task or a primitive -> budget
dict — and the ``CodesignReport`` surfaces the chosen codecs
(``codecs_by_primitive``) and the on-wire bytes saved
(``wire_bytes_saved``).  ``JobSpec`` carries the same knob through
``plan_cluster``, where smaller per-tenant flows shrink what the
horizontal layer must stagger.

The port's copy of ``repro.codesign``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax,
so the port keeps its own.
"""
from repro_torch.core.knobs import Choice, Fixed, Knob, Search  # noqa: F401

from repro_torch.codesign.placement import Placement, place_mesh  # noqa: F401
from repro_torch.codesign.report import CodesignReport, TaskChoice  # noqa: F401
from repro_torch.codesign.api import (Candidate, CodesignProblem,  # noqa: F401
                                      Objective, PlanSpace, SearchResult,
                                      plan, search)
from repro_torch.codesign.serving import (CotenantPulse, ServingReport,  # noqa: F401
                                          ServingSLO, ServingSpec,
                                          kv_bytes_per_token, plan_serving,
                                          serving_problem)
from repro_torch.codesign.placement_search import (  # noqa: F401
    balanced_placement, heuristic_placements, swap_neighbors)
from repro_torch.codesign.driver import plan_iteration  # noqa: F401
from repro_torch.codesign.cluster import (ClusterReport, JobPlan,  # noqa: F401
                                          JobSpec, plan_cluster,
                                          restagger_cluster)
from repro_torch.codesign.dynamics import (ClusterDynamics,  # noqa: F401
                                           DynamicsReport, Event, EventRecord)
