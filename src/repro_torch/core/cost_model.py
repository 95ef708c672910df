"""Analytic cost models for the AReaL-Hex scheduler, the port's copy of
``repro.core.cost_model`` (same constants, same order of operations, so
plans equal the reference's bit for bit).

Every scheduler decision (constrained search, MILP coefficients, graph
partition feedback) is driven by the three functions here:

  * ``train_step_cost``   — C_Train(σ, D_T, δ(η))       (§4.1 / §4.2.1)
  * ``replica_throughput``— h_ψ of a rollout replica     (§4.2.2, HexGen-style)
  * ``weight_sync_cost``  — C_Update(σ, D_T, τ, D_I)     (Table 2)

The models are *rooflines with calibrated efficiency factors*: each phase time
is max(compute, HBM, collective) plus explicit latency terms.  The efficiency
constants below are calibrated so the H800/H20 profiles reproduce the paper's
Table 1 per-token cost ratios (H20 ≈2.7× cheaper per inference token, H800
≈3.1× cheaper per training token) and Observation 2 (5×H20 < 1×H800 for
training).  ``serve.feedback.ServingCostModel`` overlays the serving
engine's measured slot occupancy and prefix sharing on these constants.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import Cluster, Device, DeviceProfile, PROFILES
from .model_spec import ModelSpec

# ----------------------------------------------------------------- constants
# Calibrated efficiency factors (fraction of peak achieved), per phase.
TRAIN_MFU: Dict[str, float] = {
    "H800": 0.40, "H20": 0.15, "TPUv5e": 0.45, "TPUv5p": 0.48,
}
PREFILL_MFU: Dict[str, float] = {
    "H800": 0.55, "H20": 0.42, "TPUv5e": 0.55, "TPUv5p": 0.58,
}
DECODE_COMPUTE_EFF: Dict[str, float] = {
    "H800": 0.75, "H20": 0.75, "TPUv5e": 0.70, "TPUv5p": 0.72,
}
HBM_EFF = 0.85          # achievable fraction of peak HBM bandwidth
# Serving-engine efficiency: continuous batching gaps, sampling, ragged
# attention, scheduler overhead.  Per-type: H800's larger SM count / faster
# clocks hide serving-engine latency better.  Calibrated jointly so that at
# the paper's long-CoT operating point (~12k mean rollout) the absolute
# H800:H20 generation throughput is ≈1:1 and the per-dollar ratio ≈2.7×
# in H20's favor — both straight from the paper's Table 1.
DECODE_ENGINE_EFF: Dict[str, float] = {
    "H800": 0.60, "H20": 0.30, "TPUv5e": 0.40, "TPUv5p": 0.50,
}
COLL_EFF = 0.80         # achievable fraction of peak link bandwidth
KERNEL_LAUNCH_US = 25.0  # fixed per-step scheduling overhead (us) per layer-ish op
ALLREDUCE_LAT_US = 15.0  # per-collective base latency (us)

DTYPE_BYTES = 2          # bf16 activations / weights
GRAD_BYTES = 2           # bf16 gradient all-reduce (compression doubles this win)
MEM_UTIL = 0.90          # usable fraction of HBM


def _mfu(table: Dict[str, float], profile: DeviceProfile) -> float:
    try:
        return table[profile.name]
    except KeyError:
        raise KeyError(
            f"no calibrated efficiency factor for device profile "
            f"{profile.name!r} (known: {sorted(table)}). Add the profile to "
            f"the tables in core/cost_model.py, or supply a CostProvider "
            f"that covers it."
        ) from None


_EFF_TABLES: Dict[str, Dict[str, float]] = {
    "TRAIN_MFU": TRAIN_MFU,
    "PREFILL_MFU": PREFILL_MFU,
    "DECODE_COMPUTE_EFF": DECODE_COMPUTE_EFF,
    "DECODE_ENGINE_EFF": DECODE_ENGINE_EFF,
}


def _assert_profile_coverage() -> None:
    """Every registered DeviceProfile must have an entry in every efficiency
    table — the scheduler prices plans for any profile in PROFILES, and a
    silent default would skew every MILP coefficient for that type."""
    missing = [(t, p) for t, tab in _EFF_TABLES.items()
               for p in PROFILES if p not in tab]
    assert not missing, (
        f"efficiency tables missing profiles: {missing} — every profile in "
        f"core.cluster.PROFILES needs calibrated constants in each table")


_assert_profile_coverage()


# ---------------------------------------------------------------- providers
class CostProvider:
    """Per-device efficiency factors consumed by the cost models.

    The scheduler's roofline models are parameterized by achieved-fraction
    factors (MFU, HBM efficiency, serving-engine efficiency).  A provider
    supplies them per DeviceProfile; the default ``AnalyticCostModel`` reads
    the calibrated constant tables above, and ``serve.feedback``'s
    ``ServingCostModel`` overlays factors measured on a serving engine,
    falling back to the analytic constants per factor and per device type
    where it has no report.
    """

    def train_mfu(self, profile: DeviceProfile) -> float:
        raise NotImplementedError

    def prefill_mfu(self, profile: DeviceProfile) -> float:
        raise NotImplementedError

    def decode_compute_eff(self, profile: DeviceProfile) -> float:
        raise NotImplementedError

    def decode_engine_eff(self, profile: DeviceProfile) -> float:
        raise NotImplementedError

    def hbm_eff(self, profile: DeviceProfile) -> float:
        raise NotImplementedError

    def prefill_g_eff(self, profile: DeviceProfile) -> float:
        """Effective prefill amortization from prompt-prefix sharing: a
        GRPO group of G completions prefills its shared prompt once, so
        the per-completion prefill cost is C_prefill / G_eff.  Default
        1.0 (no sharing) — concrete, not abstract, so every existing
        provider prices plans bit-identically until a serving engine
        reports a measured value (``serve.feedback.ServingCostModel``)."""
        return 1.0

    def factors(self, profile: DeviceProfile) -> Dict[str, float]:
        return {
            "train_mfu": self.train_mfu(profile),
            "prefill_mfu": self.prefill_mfu(profile),
            "decode_compute_eff": self.decode_compute_eff(profile),
            "decode_engine_eff": self.decode_engine_eff(profile),
            "hbm_eff": self.hbm_eff(profile),
            "prefill_g_eff": self.prefill_g_eff(profile),
        }


class AnalyticCostModel(CostProvider):
    """Today's hand-calibrated constants, packaged behind the provider API.

    This is the default everywhere: plans produced with ``cost_provider=None``
    and ``cost_provider=AnalyticCostModel()`` are bit-identical.
    """

    name = "analytic"

    def train_mfu(self, profile: DeviceProfile) -> float:
        return _mfu(TRAIN_MFU, profile)

    def prefill_mfu(self, profile: DeviceProfile) -> float:
        return _mfu(PREFILL_MFU, profile)

    def decode_compute_eff(self, profile: DeviceProfile) -> float:
        return _mfu(DECODE_COMPUTE_EFF, profile)

    def decode_engine_eff(self, profile: DeviceProfile) -> float:
        return _mfu(DECODE_ENGINE_EFF, profile)

    def hbm_eff(self, profile: DeviceProfile) -> float:
        return HBM_EFF


ANALYTIC = AnalyticCostModel()


def resolve_provider(provider: Optional[CostProvider]) -> CostProvider:
    return ANALYTIC if provider is None else provider


# ------------------------------------------------------------------- plans
@dataclass(frozen=True)
class StageSpec:
    """One pipeline stage of a training plan: homogeneous device block."""

    profile_name: str
    dp: int
    tp: int
    n_layers: int

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp

    @property
    def profile(self) -> DeviceProfile:
        return PROFILES[self.profile_name]


@dataclass(frozen=True)
class TrainPlan:
    """σ — the model-training execution plan (§4.2.1).

    Heterogeneous pipeline: each stage may use a different device type with its
    own DP×TP block; layer counts are set proportional to stage compute.
    """

    stages: Tuple[StageSpec, ...]
    microbatches: int = 8
    zero_shard: bool = True     # shard optimizer states over DP (ZeRO-1)

    @property
    def n_devices(self) -> int:
        return sum(s.n_devices for s in self.stages)

    @property
    def pp(self) -> int:
        return len(self.stages)

    def describe(self) -> str:
        parts = [f"{s.profile_name}[dp={s.dp},tp={s.tp},L={s.n_layers}]"
                 for s in self.stages]
        return f"PP{self.pp}(" + " | ".join(parts) + f") mb={self.microbatches}"


@dataclass(frozen=True)
class ReplicaConfig:
    """ψ — one rollout-replica configuration (§4.2.2).

    ``tp_per_stage`` mirrors the paper's s_ψ = [tp_1..tp_S]; TP is restricted
    to a single machine (ICI domain), so tp ≤ devices_per_node.
    """

    profile_name: str
    tp_per_stage: Tuple[int, ...]          # pipeline stages for serving

    @property
    def n_devices(self) -> int:
        return sum(self.tp_per_stage)

    @property
    def profile(self) -> DeviceProfile:
        return PROFILES[self.profile_name]

    def describe(self) -> str:
        return f"{self.profile_name}xPP{len(self.tp_per_stage)}tp{list(self.tp_per_stage)}"


# --------------------------------------------------------------- distribution
@dataclass
class LengthDistribution:
    """Rollout output-length distribution P, profiled at cold start (§4.2.2).

    Lognormal by default — RL reasoning rollouts are strongly right-skewed.
    """

    mean_len: float = 4096.0
    cv: float = 0.6              # coefficient of variation (skew)
    prompt_len: float = 512.0
    max_len: float = 32768.0

    def lognorm_params(self) -> Tuple[float, float]:
        sigma2 = math.log(1.0 + self.cv**2)
        mu = math.log(self.mean_len) - sigma2 / 2.0
        return mu, math.sqrt(sigma2)

    def mean(self) -> float:
        return self.mean_len

    def p95(self) -> float:
        mu, s = self.lognorm_params()
        return float(math.exp(mu + 1.645 * s))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        mu, s = self.lognorm_params()
        out = rng.lognormal(mu, s, size=n)
        return np.clip(out, 16, self.max_len).astype(np.int64)


# ------------------------------------------------------------------ training
@dataclass
class TrainCost:
    compute: float
    tp_comm: float
    dp_comm: float
    pp_comm: float
    bubble: float
    total: float
    per_device_mem: float
    feasible: bool
    reason: str = ""


def _stage_param_fraction(spec: ModelSpec, n_layers: int) -> float:
    """Fraction of total params held by a stage with n_layers layers (embeds
    folded into first/last stage — approximated as uniform for the model)."""
    return n_layers / max(spec.n_layers, 1)


def train_step_cost(
    spec: ModelSpec,
    plan: TrainPlan,
    *,
    tokens_per_step: float,
    seq_len: float = 8192.0,
    opt_state_bytes: int = 8,   # AdamW m+v in fp32 after ZeRO cast policy
    cross_stage_bw: Optional[float] = None,
    cost_provider: Optional[CostProvider] = None,
) -> TrainCost:
    """C_Train: one optimizer-step latency for a global batch of
    ``tokens_per_step`` tokens at average sequence length ``seq_len``."""
    provider = resolve_provider(cost_provider)
    total_params = spec.params()
    active_params = spec.params(active_only=True)

    stage_times: List[float] = []
    stage_tp_comm: List[float] = []
    max_mem = 0.0
    feasible = True
    reason = ""

    micro_tokens = tokens_per_step / plan.microbatches

    for st in plan.stages:
        prof = st.profile
        frac = _stage_param_fraction(spec, st.n_layers)
        # --- compute: 6·N_active·tokens plus attention quadratic term.
        lin_flops = 6.0 * active_params * frac * tokens_per_step
        window = spec.attn_window or seq_len
        attn_ctx = min(seq_len, window)
        attn_flops = (12.0 * st.n_layers * spec.hd * spec.n_heads
                      * tokens_per_step * attn_ctx / 2.0)
        flops = lin_flops + attn_flops
        eff_flops = st.dp * st.tp * prof.flops * provider.train_mfu(prof)
        t_compute = flops / eff_flops

        # --- TP collectives: 4 all-reduces per layer (2 fwd + 2 bwd) of the
        # microbatch activations, ring cost 2(tp-1)/tp, on intra-node links.
        if st.tp > 1:
            ar_bytes = micro_tokens / st.dp * spec.d_model * DTYPE_BYTES
            per_ar = (2.0 * (st.tp - 1) / st.tp) * ar_bytes / (prof.intra_bw * COLL_EFF)
            t_tp = plan.microbatches * st.n_layers * 4 * (per_ar + ALLREDUCE_LAT_US * 1e-6)
        else:
            t_tp = 0.0

        stage_times.append(t_compute)
        stage_tp_comm.append(t_tp)

        # --- memory: bf16 params + grads on each TP shard; optimizer states
        # additionally sharded over DP when zero_shard.
        p_shard = total_params * frac / st.tp
        mem = p_shard * (DTYPE_BYTES + GRAD_BYTES)
        mem += p_shard * opt_state_bytes / (st.dp if plan.zero_shard else 1)
        # activations (with checkpointing ≈ 2 × d_model bytes per token per layer)
        mem += (micro_tokens / st.dp) * st.n_layers * spec.d_model * DTYPE_BYTES * 2
        max_mem = max(max_mem, mem)
        if mem > prof.hbm_cap * MEM_UTIL:
            feasible = False
            reason = (f"stage {st.profile_name} needs {mem/1e9:.1f} GB "
                      f"> {prof.hbm_cap*MEM_UTIL/1e9:.1f} GB")

    # --- DP gradient all-reduce, overlapped with backward up to 50%.
    t_dp = 0.0
    for st in plan.stages:
        if st.dp > 1:
            prof = st.profile
            g_bytes = total_params * _stage_param_fraction(spec, st.n_layers) \
                / st.tp * GRAD_BYTES
            nodes = max(1, st.n_devices // prof.devices_per_node)
            bw = prof.inter_bw if nodes > 1 else prof.intra_bw
            t = (2.0 * (st.dp - 1) / st.dp) * g_bytes / (bw * COLL_EFF)
            t_dp = max(t_dp, 0.5 * t)   # overlap credit

    # --- PP: activation transfers + bubble.
    t_pp = 0.0
    if plan.pp > 1:
        act_bytes = micro_tokens * spec.d_model * DTYPE_BYTES
        for a, b in zip(plan.stages[:-1], plan.stages[1:]):
            bw = (cross_stage_bw if cross_stage_bw is not None else
                  min(a.profile.inter_bw, b.profile.inter_bw)
                  if a.profile_name == b.profile_name else 1.5e9)
            t_pp += 2.0 * plan.microbatches * act_bytes / (bw * COLL_EFF)

    slowest = max(t + c for t, c in zip(stage_times, stage_tp_comm))
    bubble = (plan.pp - 1) / plan.microbatches * slowest
    overhead = KERNEL_LAUNCH_US * 1e-6 * spec.n_layers
    total = slowest + bubble + t_dp + t_pp + overhead

    return TrainCost(
        compute=max(stage_times), tp_comm=max(stage_tp_comm), dp_comm=t_dp,
        pp_comm=t_pp, bubble=bubble, total=total,
        per_device_mem=max_mem, feasible=feasible, reason=reason,
    )


# ------------------------------------------------------------------- rollout
@dataclass
class ReplicaCost:
    batch: int
    prefill_time: float
    decode_step_time: float
    tokens_per_sec: float
    per_device_mem: float
    feasible: bool
    reason: str = ""
    # fraction of the decode-step roofline attributable to KV-cache reads —
    # the context-proportional share a GenTimeModel grows with length
    kv_frac: float = 0.0


def replica_throughput(
    spec: ModelSpec,
    cfg: ReplicaConfig,
    P: LengthDistribution,
    *,
    batch_cap: int = 256,
    cost_provider: Optional[CostProvider] = None,
) -> ReplicaCost:
    """h_ψ: steady-state generated tokens/s of one rollout replica (§4.2.2).

    HexGen-style: memory-derived max batch, prefill compute roofline, decode
    max(weight-read, KV-read, compute) roofline per step, TP latency adders.
    """
    provider = resolve_provider(cost_provider)
    prof = cfg.profile
    n = cfg.n_devices
    p_len, o_len = P.prompt_len, P.mean()
    total_ctx = p_len + o_len

    w_bytes = spec.weight_bytes(DTYPE_BYTES)
    w_per_dev = w_bytes / n
    if w_per_dev > prof.hbm_cap * MEM_UTIL:
        return ReplicaCost(0, 0, 0, 0.0, w_per_dev, False,
                           f"weights {w_per_dev/1e9:.1f} GB/dev > cap")

    kv_tok = spec.kv_bytes_per_token(DTYPE_BYTES)
    state_b = spec.state_bytes(DTYPE_BYTES)
    free = prof.hbm_cap * MEM_UTIL - w_per_dev
    per_seq = (kv_tok * total_ctx + state_b) / n
    batch = int(min(batch_cap, max(1, free / max(per_seq, 1.0))))

    active = spec.params(active_only=True)

    # Prefill: compute-bound.  Prefix sharing (GRPO groups prefill their
    # shared prompt once — serve.engine COW forks) amortizes the cost over
    # G_eff completions; the default provider reports 1.0, so plans stay
    # bit-identical until an engine measures real sharing.
    pf_flops = 2.0 * active * batch * p_len \
        + 4.0 * spec.n_layers * spec.n_heads * spec.hd * batch * p_len**2 / 2.0
    t_prefill = pf_flops / (n * prof.flops * provider.prefill_mfu(prof)) \
        / max(provider.prefill_g_eff(prof), 1.0)

    # Decode step: one token for every sequence in the batch.
    avg_ctx = p_len + o_len / 2.0
    if spec.attn_window:
        avg_ctx = min(avg_ctx, spec.attn_window)
    hbm_eff = provider.hbm_eff(prof)
    t_w = w_bytes / n / (prof.hbm_bw * hbm_eff)                       # weight read
    t_kv = batch * (kv_tok * avg_ctx + state_b) / n / (prof.hbm_bw * hbm_eff)
    t_c = 2.0 * active * batch / (n * prof.flops
                                  * provider.decode_compute_eff(prof))
    t_lat = 0.0
    tp = max(cfg.tp_per_stage)
    if tp > 1:
        # 2 all-reduces per layer per decode step, latency-dominated.
        ar_bytes = batch * spec.d_model * DTYPE_BYTES
        t_lat = spec.n_layers * 2 * (
            ALLREDUCE_LAT_US * 1e-6
            + (2.0 * (tp - 1) / tp) * ar_bytes / (prof.intra_bw * COLL_EFF))
    if len(cfg.tp_per_stage) > 1:
        # pipelined serving adds inter-stage hop latency per token
        t_lat += (len(cfg.tp_per_stage) - 1) * (
            batch * spec.d_model * DTYPE_BYTES / (prof.inter_bw * COLL_EFF))
    t_decode = max(t_w, t_kv, t_c) + t_lat + KERNEL_LAUNCH_US * 1e-6

    gen_time = t_prefill + o_len * t_decode
    tps = batch * o_len / gen_time * provider.decode_engine_eff(prof)

    mem = w_per_dev + batch * per_seq
    return ReplicaCost(
        batch=batch, prefill_time=t_prefill, decode_step_time=t_decode,
        tokens_per_sec=tps, per_device_mem=mem,
        feasible=mem <= prof.hbm_cap * MEM_UTIL,
        kv_frac=t_kv / t_decode if t_decode > 0 else 0.0,
    )


# --------------------------------------------------------- generation time
@dataclass
class GenTimeModel:
    """Length-distribution-aware generation time for one rollout.

    The simulator historically charged a rollout of length L a *fixed*
    per-token constant: (prompt + L) / h_ψ.  Real decode is not constant
    per token — every step re-reads the KV cache, so the per-token cost
    grows linearly with context and a long rollout is superlinearly more
    expensive than a short one (the tail that continuous batching exists
    to absorb).  This model prices that:

        T(L) = t_prefill + a·L + b·L·(prompt + L/2)

    (a = context-independent share: weight read, launch, collectives;
    b = per-context-token share: the KV stream; prompt + L/2 is the mean
    context over the rollout).  ``duration`` rescales T so a mean-length
    rollout still takes (prompt + mean)/tokens_per_sec — the plan-level
    throughput h_ψ stays authoritative, the model redistributes time over
    the length distribution.

    Coefficients come from the cost model (``from_replica_cost``) or are
    fit to a serving engine's per-request samples (serve.feedback).

    ``g_eff`` is the prefix-sharing amortization (serve.engine COW forks:
    a GRPO group of G completions prefills its prompt once, so each
    rollout carries t_prefill / G_eff).  Default 1.0 — existing fits and
    simulator runs are bit-identical.  ``from_replica_cost`` keeps
    g_eff=1 because ``ReplicaCost.prefill_time`` is already priced
    through the provider's ``prefill_g_eff``.
    """

    a: float                       # seconds/token, context-independent
    b: float                       # seconds/token per context token
    t_prefill: float = 0.0
    g_eff: float = 1.0             # prefix-sharing prefill amortization
    # multi-turn agentic episodes: (turns − 1) inter-turn gaps of
    # ``turn_gap_s`` wall seconds each (measured tool/env latency minus
    # whatever async overlap hides) are added ON TOP of generation time —
    # env time is not generation, so it must not be normalized away
    # against the replica's token throughput.  Defaults (1 turn / 0 gap)
    # keep every existing fit and simulator run bit-identical.  When a
    # SimConfig also carries an EnvCostModel, leave these at defaults —
    # the simulator samples the same gaps stochastically there.
    turns: float = 1.0
    turn_gap_s: float = 0.0

    def raw(self, prompt_len: float, length: float) -> float:
        return (self.t_prefill / max(self.g_eff, 1.0) + self.a * length
                + self.b * length * (prompt_len + length / 2.0))

    def duration(self, length: float, *, prompt_len: float,
                 tokens_per_sec: float, mean_len: float) -> float:
        """Seconds for one rollout of ``length`` on a replica whose
        steady-state rate is ``tokens_per_sec`` under mean length
        ``mean_len``."""
        base = (mean_len + prompt_len) / max(tokens_per_sec, 1e-9)
        gap = max(self.turns - 1.0, 0.0) * self.turn_gap_s
        ref = self.raw(prompt_len, mean_len)
        if ref <= 0.0:
            return (length + prompt_len) / max(tokens_per_sec, 1e-9) + gap
        return base * self.raw(prompt_len, length) / ref + gap

    @classmethod
    def from_replica_cost(cls, rc: "ReplicaCost",
                          P: "LengthDistribution") -> "GenTimeModel":
        """Split the replica's decode roofline into constant vs
        context-proportional shares (kv_frac) evaluated at the mean
        context the roofline was priced at."""
        per_tok = rc.decode_step_time / max(rc.batch, 1)
        avg_ctx = P.prompt_len + P.mean() / 2.0
        b = rc.kv_frac * per_tok / max(avg_ctx, 1.0)
        a = (1.0 - rc.kv_frac) * per_tok
        return cls(a=a, b=b, t_prefill=rc.prefill_time / max(rc.batch, 1))


# ------------------------------------------------------------- environment
@dataclass
class EnvCostModel:
    """Reward/environment computation priced as the paper's THIRD stage.

    AReaL-Hex names three coupled stages — rollout generation, reward/env
    computation, policy updates — and the repo historically modeled the
    middle one as a flat ``reward_cost_s`` constant.  Agentic multi-turn
    workloads (RollArt in PAPERS.md) break that: an episode leaves the
    GPU for a tool/env call between turns, so env latency both (a) adds a
    pool-level stage time the γ split must account for and (b) *stalls
    rollout replicas* between turns, deflating their effective generated
    tokens/s in a device-dependent way — a fast replica finishes its turn
    sooner and therefore idles a LARGER fraction of wall time on the same
    env call (HetRL's heterogeneity-aware costing argument).

    The env pool is its own "device type": ``workers`` concurrent CPU-ish
    workers with a lognormal per-call latency (``mean_s``, ``cv``).  An
    episode of ``turns`` turns makes ``turns − 1`` env calls; ``overlap``
    is the fraction of each call hidden by async continuation (other
    slots keep decoding — the engine's continuous batching provides the
    mechanism, the scheduler prices what's left).

    Defaults are inert: ``turns=1`` means no env calls, every method
    returns its no-op value, and plans stay bit-identical — the contract
    every scheduler knob in this repo keeps.
    """

    mean_s: float = 0.1            # mean env/tool latency per call
    cv: float = 0.5                # latency coefficient of variation
    turns: float = 1.0             # turns per episode (1 → no env stage)
    workers: int = 64              # concurrent env workers in the pool
    overlap: float = 0.0           # fraction of latency hidden by overlap
    device_type: str = "ENVPOOL"   # label in plans/reports (not a PROFILE)

    @property
    def calls_per_episode(self) -> float:
        return max(self.turns - 1.0, 0.0)

    def episode_gap_s(self) -> float:
        """Mean un-overlapped env wall time one episode waits across all
        its inter-turn gaps (what ``GenTimeModel.turn_gap_s`` carries when
        fit from a serving trace)."""
        return self.mean_s * (1.0 - self.overlap)

    def stage_time(self, episodes: float) -> float:
        """C_Env: wall time for the pool's ``workers`` to process the env
        calls of ``episodes`` episodes (the third-stage term added to the
        per-step inference cost in ``scheduler._evaluate_allocation``)."""
        calls = self.calls_per_episode * episodes
        return calls * self.mean_s / max(self.workers, 1)

    def replica_util(self, rc: ReplicaCost, P: LengthDistribution) -> float:
        """Busy fraction of a rollout replica whose slots stall on env
        calls between turns: turns·t_turn / (turns·t_turn + gaps).  Used
        to deflate h_ψ in the MILP — slower replicas take longer per turn
        and so hide the same env latency better (util → 1), which shifts
        the optimal Ψ mix across heterogeneous device types."""
        if self.calls_per_episode <= 0.0 or self.mean_s <= 0.0:
            return 1.0
        per_slot = rc.tokens_per_sec / max(rc.batch, 1)
        t_turn = (P.mean() / max(self.turns, 1.0)) / max(per_slot, 1e-9)
        busy = self.turns * t_turn
        stalled = self.calls_per_episode * self.episode_gap_s()
        return busy / max(busy + stalled, 1e-9)

    def lognorm_params(self) -> Tuple[float, float]:
        sigma2 = math.log(1.0 + self.cv**2)
        mu = math.log(max(self.mean_s, 1e-9)) - sigma2 / 2.0
        return mu, math.sqrt(sigma2)

    def sample_gaps(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Un-overlapped per-call env latencies for ``n`` episodes' worth
        of calls (simulators add these to each rollout's completion
        time)."""
        if n <= 0:
            return np.zeros(0)
        mu, s = self.lognorm_params()
        return rng.lognormal(mu, s, size=n) * (1.0 - self.overlap)


# --------------------------------------------------------------- weight sync
def weight_sync_cost(
    spec: ModelSpec,
    cluster: Cluster,
    d_train: Sequence[Device],
    d_infer: Sequence[Device],
    *,
    quantize_bytes: int = DTYPE_BYTES,
) -> float:
    """C_Update: broadcast new policy weights from trainers to rollout workers.

    Weights cross the narrowest cut between the two pools (the paper's 1.5 GB/s
    hetero link), then fan out intra-pool via NCCL/ICI broadcast.  Cost model:
    size/bw over the bottleneck + intra-pool broadcast at pool link speed.
    """
    if not d_infer:
        return 0.0
    w = spec.params() * quantize_bytes
    # narrowest edge crossing the (D_T, D_I) cut — pick the *best* link crossing
    # the cut (the transfer is scheduled over it), aggregated over parallel
    # disjoint node pairs.
    cross_links: Dict[Tuple[int, int], float] = {}
    for a in d_train:
        for b in d_infer:
            key = (a.node, b.node)
            bw = cluster.link_bw(a, b)
            cross_links[key] = max(cross_links.get(key, 0.0), bw)
    agg_cross = sum(cross_links.values())
    if agg_cross <= 0:
        agg_cross = 1.5e9
    t_cross = w / (agg_cross * COLL_EFF)
    # intra-pool broadcast (tree) at the pool's slowest profile inter bw
    pool_bw = min(d.profile.inter_bw for d in d_infer)
    n_nodes = len({d.node for d in d_infer})
    t_fan = w / (pool_bw * COLL_EFF) * math.ceil(math.log2(max(n_nodes, 2)))
    return t_cross + t_fan


# ------------------------------------------------------- per-token economics
def per_token_costs(spec: ModelSpec, profile: DeviceProfile,
                    P: Optional[LengthDistribution] = None,
                    n_devices: int = 8,
                    cost_provider: Optional[CostProvider] = None,
                    ) -> Tuple[float, float]:
    """($/inference-token, $/training-token) for one device type — Table 1."""
    P = P or LengthDistribution()
    tp = min(n_devices, profile.devices_per_node)
    # pick the best single-node replica for inference
    best_tps = 0.0
    for t in (1, 2, 4, 8):
        if t > tp:
            continue
        rc = replica_throughput(spec, ReplicaConfig(profile.name, (t,)), P,
                                cost_provider=cost_provider)
        if rc.feasible:
            best_tps = max(best_tps, rc.tokens_per_sec * (n_devices // t))
    infer_cost = (profile.price_per_hour * n_devices / 3600.0) / max(best_tps, 1e-9)

    plan = TrainPlan(stages=(StageSpec(profile.name, dp=max(1, n_devices // tp),
                                       tp=tp, n_layers=spec.n_layers),))
    tc = train_step_cost(spec, plan, tokens_per_step=n_devices * 8192.0,
                         cost_provider=cost_provider)
    train_tps = n_devices * 8192.0 / tc.total
    train_cost = (profile.price_per_hour * n_devices / 3600.0) / max(train_tps, 1e-9)
    return infer_cost, train_cost
