"""Measured-cost subsystem of the port: the autotuner of its own Hopper
kernels, the CostDB and the scheduler overlay (a copy of
``repro.autotune`` over the port's kernels).

Closes the kernel → cost-model → scheduler loop: ``run_sweep`` times every
feasible knob config of the four kernels (K1 flash attention, K3 flash
decode, K2 paged flash decode, K4 mLSTM scan) on the local card with CUDA
events (device type ``"H100"``) and estimates the scheduler's profiles
(H800 / H20) by the reference's roofline; ``CostDB`` persists the winners
in the reference's JSON format; ``MeasuredCostModel`` re-derives the
scheduler's efficiency factors for the profiles it has records of;
``load_tuned_defaults`` feeds the winning knobs into
``kernels.tuning``, which the wrappers resolve.

    # sweep on the card (and estimate H800 / H20), persist
    python -m repro_torch.autotune sweep --emit-costdb build/costdb.json
    # estimates only, on the CPU
    python -m repro_torch.autotune sweep --device cpu --tiny \\
        --emit-costdb /tmp/costdb.json
    # inspect / merge / check
    python -m repro_torch.autotune show build/costdb.json
    python -m repro_torch.autotune merge a.json b.json -o merged.json
    python -m repro_torch.autotune validate build/costdb.json

    # schedule with measured costs
    db = CostDB.load("build/costdb.json")
    plan = schedule(spec, cluster, cost_provider=MeasuredCostModel(db))
"""
from .costdb import (CostDB, CostDBSchemaError, CostDBVersionError, Record,
                     SCHEMA_VERSION)
from .measured import MeasuredCostModel, card_fractions, load_tuned_defaults
from .space import SPACES, ShapeBucket
from .sweep import run_sweep

__all__ = [
    "CostDB", "CostDBSchemaError", "CostDBVersionError", "Record",
    "SCHEMA_VERSION", "MeasuredCostModel", "card_fractions",
    "load_tuned_defaults", "SPACES", "ShapeBucket", "run_sweep",
]
