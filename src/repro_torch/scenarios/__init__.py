"""Synthetic scenario engine: generators that emit SynapseProfiles directly.

The registry (``base``) plus one module per scenario family — importing this
package registers them all:

  * ``training_scan``     — identical train steps + periodic checkpoint bursts
  * ``serving_traffic``   — Poisson arrivals over prefill/decode rooflines
  * ``fanout_straggler``  — N parallel workers, one tail-latency outlier
  * ``retry_storm``       — flaky work re-consumed under exponential backoff
  * ``mixed_fleet``       — weighted blend of the families above
  * ``dag_diamond``       — fork-join diamond, one seeded straggler branch
  * ``deep_chain``        — deep sequential chain, all critical path

``algebra`` composes profiles (``concat``/``overlay``/``scale``) and
structures them as dependency DAGs (``WorkloadDag`` via ``chain``/
``fork_join``) — feed a ``WorkloadDag`` to ``Emulator.emulate_many`` on a
process fleet for frontier-scheduled replay with critical-path metrics in
``FleetReport.dag``.

``driver.run_scenario`` wires a scenario end-to-end
(generate -> predict -> emulate -> store); ``driver.run_fleet`` replays many
concurrently through ``Emulator.emulate_many`` — on worker threads, or on
the process-level fleet executor (``repro_torch.fleet``).  ``__main__``
is the command-line front door: ``python -m repro_torch.scenarios
list|run|fleet|serve|trace``.
"""
from repro_torch.scenarios import (dag, fanout, mixed, retry,  # noqa
                                   serving, training)
from repro_torch.scenarios.algebra import (DagNode, WorkloadDag,  # noqa
                                           chain, concat, fork_join,
                                           overlay, scale)
from repro_torch.scenarios.base import (ScenarioSpec, generate,  # noqa
                                        get_scenario, list_scenarios,
                                        register, validate)
from repro_torch.scenarios.driver import (DEFAULT_SPECS,  # noqa
                                          FleetResult, ScenarioResult,
                                          run_fleet, run_scenario)
