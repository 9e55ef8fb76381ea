"""FIKIT core, copied from the JAX package's ``repro.core``.

Every module here except ``kernel_id`` is the reference's source with the
import prefix changed (``tests/test_torch_core_copy.py`` pins that);
``kernel_id._aval_fp`` also names torch dtypes. Nothing here imports
torch.
"""
from repro_torch.core.kernel_id import KernelID, kernel_id_for  # noqa: F401
from repro_torch.core.task import (  # noqa: F401
    KernelRequest, Priority, TaskKey, TaskSpec, TraceKernel,
)
from repro_torch.core.profiler import ProfiledData, Profiler, TaskProfile  # noqa: F401
from repro_torch.core.online import OnlineConfig, OnlineMeasurement  # noqa: F401
from repro_torch.core.queues import PriorityQueues  # noqa: F401
from repro_torch.core.fikit import (  # noqa: F401
    EPSILON, best_prio_fit, best_prio_fit_scan, fikit_procedure,
)
from repro_torch.core.policy import (  # noqa: F401
    FikitPolicy, ListTrace, NullTrace, RingTrace, make_trace_sink,
)
from repro_torch.core.placement import DISCIPLINES, PlacementLayer  # noqa: F401
from repro_torch.core.scheduler import Mode, SimScheduler  # noqa: F401
