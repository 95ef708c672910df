"""The discrete-event async-RL simulator and its elastic replanners, the
port's copy of ``repro.sim`` (host numpy; the card enters only through
the plans it executes)."""
from .events import (ControllerCrash, FailureInjection, HandoffRecord,
                     JobArrival, JobFailure, JobStraggler, PlanSwapRecord,
                     ReplanTrigger, StragglerInjection)
from .replan import (ElasticConfig, ElasticReplanner, PoolReplanner,
                     replica_device_map)
from .simulator import (AsyncRLSimulator, DeviceLedger, MultiJobSimResult,
                        MultiJobSimulator, MultiSimConfig, PlanEpochStat,
                        SimConfig, SimResult)

__all__ = [
    "AsyncRLSimulator", "SimConfig", "SimResult", "PlanEpochStat",
    "ElasticConfig", "ElasticReplanner",
    "FailureInjection", "StragglerInjection",
    "ReplanTrigger", "PlanSwapRecord",
    "MultiJobSimulator", "MultiSimConfig", "MultiJobSimResult",
    "PoolReplanner", "DeviceLedger", "JobFailure", "JobStraggler",
    "JobArrival", "HandoffRecord", "ControllerCrash",
    "replica_device_map",
]
