"""Scheduler middleware — the two layers the paper ADDS to get from the
three-layer to the five-layer paradigm (Sec. IV-A).

``tasks``  — task scheduler ("Vertical" co-design): orders the comm tasks a
             parallelization strategy emits, overlapping them with compute
             to minimize JCT (Lina-style priority, Echelon-style slack).
``flows``  — flow scheduler ("Horizontal" co-design): places multiple jobs'
             flows onto shared links (CASSINI-style staggering), periodic
             training profiles and non-periodic serving bursts alike.
``arrivals`` — open-loop request processes (seeded Poisson /
             trace-driven) feeding the serving co-design layer.
``atp``    — "Host-Net" co-design: in-network aggregation modeling (ATP).

The port's copy of ``repro.sched``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from repro_torch.sched.tasks import SimResult, simulate_iteration  # noqa: F401
from repro_torch.sched.flows import (BurstProfile, JobProfile,  # noqa: F401
                                     multi_job_jct, stagger_jobs,
                                     stagger_mixed, worst_stretch)
from repro_torch.sched.arrivals import (Arrival, PoissonArrivals,  # noqa: F401
                                        TraceArrivals, demand_series,
                                        offered_load)
