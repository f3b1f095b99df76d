"""The port's serving runtime: admission and request lifecycle
(``admission.py``), fault injection (``faults.py``) and the continuous-
batching ``Server`` over a TransferProgram-backed ServeState
(``serve.py``).  Training (``loop.py``, ``train.py``) waits for its slice."""
from .admission import (ACCEPTED, COMPLETED, FAILED, SHED, TIMED_OUT,
                        AdmissionQueue, Backoff, LifecycleError,
                        LifecycleTracker, RequestTimeout, ServeStats)
from .faults import FaultInjector, InjectedFault, injected
from .serve import (TRANSIENT_FAULTS, Request, Server,
                    serve_transfer_policy)

__all__ = ["ACCEPTED", "COMPLETED", "FAILED", "SHED", "TIMED_OUT",
           "AdmissionQueue", "Backoff", "LifecycleError", "LifecycleTracker",
           "RequestTimeout", "ServeStats",
           "FaultInjector", "InjectedFault", "injected",
           "TRANSIENT_FAULTS", "Request", "Server", "serve_transfer_policy"]
