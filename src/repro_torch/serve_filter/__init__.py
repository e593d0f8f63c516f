"""Filter-serving subsystem of the port: batched membership queries.

The JAX package's ``repro.serve_filter`` in PyTorch, single-tenant and
local for this slice: ``config`` (the declarative ``ServeConfig`` /
``TenantSpec`` vocabulary and the tenant lifecycle), ``plan`` (the
frozen ``QueryPlan`` and the planner), ``executors`` (``LocalExecutor``:
the ``query_stages`` pipeline on one device, with the fixup probe routed
to the CUDA kernel of ``kernels/bloom_query`` under
``ProbeConfig(use_kernel=True)``), ``registry`` (admit / hydrate /
evict, LRU budget, lifecycle), ``scheduler`` (padding buckets,
round-robin, futures, deadlines), ``stats`` and ``server``
(``FilterServer`` and ``TenantHandle``).

Quick use::

    server = FilterServer(use_kernel=True)          # on cuda
    handle = server.admit(TenantSpec("airplane", index=idx))
    answers = handle.submit(ids).result()
"""
from repro_torch.serve_filter.config import (BucketConfig, DispatchConfig,
                                             GroupingConfig, MetricsConfig,
                                             PlacementConfig, QuantConfig,
                                             ServeConfig, TenantSpec,
                                             TenantState)
from repro_torch.serve_filter.executors import (Executor, LocalExecutor,
                                                PlacedFilter,
                                                acquire_executor,
                                                clear_executors,
                                                compiled_program_count,
                                                executor_for,
                                                release_executor)
from repro_torch.serve_filter.faults import (NULL_INJECTOR,
                                             DeadlineExceeded, FaultConfig,
                                             FaultInjector, InjectedFault,
                                             Overloaded, ReliabilityConfig,
                                             backoff_delays)
from repro_torch.serve_filter.plan import (Placement, ProbeConfig,
                                           QueryPlan, plan_query)
from repro_torch.serve_filter.registry import FilterEntry, FilterRegistry
from repro_torch.serve_filter.scheduler import (DEFAULT_BUCKETS,
                                                FilterServeError,
                                                QueryFuture, QueryRequest,
                                                QueryScheduler, bucket_for,
                                                wait_all)
from repro_torch.serve_filter.server import FilterServer, TenantHandle
from repro_torch.serve_filter.stats import ServeStats, TenantStats
