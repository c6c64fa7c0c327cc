"""Synthetic scenario engine: generators that emit SynapseProfiles directly.

The registry (``base``) plus one module per scenario family — importing this
package registers them.  Ported so far:

  * ``serving_traffic``   — Poisson arrivals over prefill/decode rooflines
"""
from repro_torch.scenarios import serving  # noqa
from repro_torch.scenarios.base import (ScenarioSpec, generate,  # noqa
                                        get_scenario, list_scenarios,
                                        register, validate)
