"""The AReaL-Hex scheduler, the port's copy of the reference's ``repro.core``
(host code: numpy and scipy, no torch).

  * ``model_spec``, ``cluster`` — the coarse model and device descriptions.
  * ``cost_model`` — the roofline cost models and ``CostProvider``s.
  * ``staleness`` — bounded-staleness bookkeeping and the adaptive δ(η).
  * ``plan``, ``constrained_search``, ``milp``, ``graph_partition`` —
    the plan types and the two phases of Algorithm 1.
  * ``scheduler`` — ``schedule`` / ``reschedule`` and their baselines.
  * ``pool``, ``jobs`` — multi-job arbitration and the control plane.
"""
