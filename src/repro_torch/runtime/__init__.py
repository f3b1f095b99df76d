"""The port's runtime: admission and request lifecycle (``admission.py``),
fault injection and the elastic restart (``faults.py``), the
continuous-batching ``Server`` over a TransferProgram-backed ServeState
(``serve.py``), the train steps (the production-mesh one among them) and
the train state's transfer policy (``train.py``), placed prefill and
decode on a named mesh (``placed.py``) and the fault-tolerant training
loop (``loop.py``)."""
from .admission import (ACCEPTED, COMPLETED, FAILED, SHED, TIMED_OUT,
                        AdmissionQueue, Backoff, LifecycleError,
                        LifecycleTracker, RequestTimeout, ServeStats)
from .faults import (ElasticResult, FaultInjector, InjectedFault, injected,
                     run_elastic, trajectory_diff)
from .loop import (NodeFailure, RestoreError, StragglerWatchdog,
                   TrainLoopResult, run)
from .serve import (TRANSIENT_FAULTS, Request, Server,
                    serve_transfer_policy)
from .train import (ShardedTrainStep, StatePrefetcher, abstract_train_state,
                    compile_state_program, grad_arena_spec,
                    init_error_state, loss_and_grads, make_dp_train_step,
                    make_sharded_train_step, make_train_step,
                    replicate_state, state_transfer_policy, train_state,
                    train_state_axes)
from .placed import PlacedServe

__all__ = ["ACCEPTED", "COMPLETED", "FAILED", "SHED", "TIMED_OUT",
           "AdmissionQueue", "Backoff", "LifecycleError", "LifecycleTracker",
           "RequestTimeout", "ServeStats",
           "ElasticResult", "FaultInjector", "InjectedFault", "injected",
           "run_elastic", "trajectory_diff",
           "NodeFailure", "RestoreError", "StragglerWatchdog",
           "TrainLoopResult", "run",
           "ShardedTrainStep", "StatePrefetcher", "abstract_train_state",
           "compile_state_program", "grad_arena_spec", "init_error_state",
           "loss_and_grads", "make_dp_train_step", "make_sharded_train_step",
           "make_train_step", "replicate_state", "state_transfer_policy",
           "train_state", "train_state_axes", "PlacedServe",
           "TRANSIENT_FAULTS", "Request", "Server", "serve_transfer_policy"]
