"""Synapse core on PyTorch: profile -> store -> emulate on a CUDA card ->
predict TTC on hardware you don't have (roofline terms per sample).

Ported so far: the datamodel, the atoms (compute, memory, collective,
storage), the schedule compiler, the emulator with its thread and process
fleets (``Emulator.emulate_many``, ``repro_torch.fleet``), calibration,
the predictor, the store and the runtime watchers.  The static profiler is
not ported yet.
"""
from repro_torch.core.atoms import (CollectiveAtom,  # noqa
                                    CollectiveQuant, CollectiveSpec,
                                    ComputeAtom, ComputeSpec, MemoryAtom,
                                    MemorySpec, Plan, PlanCache, StorageAtom,
                                    StorageSpec, collective_factor)
from repro_torch.core.calibrate import HostCalibration, calibrate  # noqa
from repro_torch.core.emulator import (EmulationReport, Emulator,  # noqa
                                       EmulatorSpec, FleetReport, ReportFold)
from repro_torch.core.schedule import (BarrierStep, CompiledSchedule,  # noqa
                                       FusedSegment, SegmentRunner,
                                       compile_schedule, rehydrate_schedule)
from repro_torch.core.hardware import (H100_SXM,  # noqa
                                       HOST_ARCHER_NODE, HOST_I7_M620,
                                       HOST_STAMPEDE_NODE, TPU_V5E,
                                       TPU_V5E_2POD, TPU_V5E_POD,
                                       HardwareSpec, get_spec)
from repro_torch.core.metrics import (ResourceVector, Sample,  # noqa
                                      SynapseProfile)
from repro_torch.core.predictor import (Prediction, RooflineTerms,  # noqa
                                        compare, from_dryrun_artifact,
                                        llm_request_resources, predict,
                                        predict_fleet, predict_resources,
                                        terms_for)
from repro_torch.core.store import ProfileStore  # noqa
from repro_torch.core.watchers import (CPUWatcher, IOWatcher,  # noqa
                                       MemWatcher, RuntimeProfiler,
                                       WatcherBase, host_sysinfo)
