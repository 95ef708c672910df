"""Heterogeneous cluster model, the port's copy of ``repro.core.cluster``.

The AReaL-Hex scheduler is hardware-agnostic: every decision it makes is a
function of per-device profiles (peak FLOPS, HBM bandwidth/capacity) and the
pairwise link-bandwidth graph.  We ship the paper's H800/H20 profiles (used to
reproduce its tables) and the reference's TPU profiles, with the same
constants: ``PROFILES``' order is part of every plan (the scheduler walks it),
so the port adds no profile the reference lacks.

Units: FLOPS in FLOP/s, bandwidths in bytes/s, memory in bytes, prices in $/h.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

GB = 1024**3
TB = 1024**4
TFLOPS = 1e12


@dataclass(frozen=True)
class DeviceProfile:
    """Static capability profile of one accelerator type."""

    name: str
    flops: float                 # peak dense bf16/fp16 tensor FLOP/s
    hbm_bw: float                # HBM bandwidth, bytes/s
    hbm_cap: float               # HBM capacity, bytes
    intra_bw: float              # intra-machine (NVLink / ICI) link bw, bytes/s, unidirectional
    inter_bw: float              # inter-machine same-type bw, bytes/s
    price_per_hour: float = 0.0  # rental price, $/h
    devices_per_node: int = 8

    @property
    def flops_per_dollar(self) -> float:
        return self.flops / max(self.price_per_hour, 1e-9)

    @property
    def bytes_per_dollar(self) -> float:
        return self.hbm_bw / max(self.price_per_hour, 1e-9)


# --- Profiles used by the paper (§4.4) --------------------------------------
# H20: 148 TFLOPS, 4 TB/s HBM, 450 GB/s NVLink, 96 GB. $1.85/h (MegaScale-Infer).
H20 = DeviceProfile(
    name="H20",
    flops=148 * TFLOPS,
    hbm_bw=4.0e12,
    hbm_cap=96 * GB,
    intra_bw=450 * 1e9,
    inter_bw=5 * 1e9,
    price_per_hour=1.85,
)
# H800: 756 TFLOPS (sparsity-off tensor core ~756 per paper), 2 TB/s HBM wait —
# paper: "756 TFLOPS ... 2 TB/s memory bandwidth ... 200 GB/s NVLink", 80 GB.
H800 = DeviceProfile(
    name="H800",
    flops=756 * TFLOPS,
    hbm_bw=2.0e12,
    hbm_cap=80 * GB,
    intra_bw=200 * 1e9,
    inter_bw=5 * 1e9,
    price_per_hour=5.28,
)

# --- TPU deployment profiles (our target runtime) ----------------------------
# v5e: roofline constants fixed by the assignment: 197 TFLOP/s bf16, 819 GB/s
# HBM, ~50 GB/s/link ICI.  v5p-like trainer pool for heterogeneous TPU studies.
TPU_V5E = DeviceProfile(
    name="TPUv5e",
    flops=197 * TFLOPS,
    hbm_bw=819e9,
    hbm_cap=16 * GB,
    intra_bw=50e9,          # ICI per link
    inter_bw=6.25e9,        # DCN, modeled
    price_per_hour=1.20,
    devices_per_node=4,
)
TPU_V5P = DeviceProfile(
    name="TPUv5p",
    flops=459 * TFLOPS,
    hbm_bw=2.765e12,
    hbm_cap=95 * GB,
    intra_bw=100e9,
    inter_bw=6.25e9,
    price_per_hour=4.20,
    devices_per_node=4,
)

PROFILES: Dict[str, DeviceProfile] = {
    p.name: p for p in (H20, H800, TPU_V5E, TPU_V5P)
}

# Cross-type inter-machine bandwidth (paper: 1.5 GB/s between H20 and H800).
DEFAULT_CROSS_TYPE_BW = 1.5e9


@dataclass(frozen=True)
class Device:
    """One physical accelerator: a profile instance placed on a node."""

    index: int                  # global id within the cluster
    profile: DeviceProfile
    node: int                   # machine id (devices on the same node share NVLink/ICI)

    @property
    def type_name(self) -> str:
        return self.profile.name


@dataclass
class Cluster:
    """A heterogeneous device set D with its link-bandwidth graph.

    ``link_bw(a, b)`` follows the paper's topology model: intra-node NVLink/ICI,
    inter-node same-type Ethernet/DCN, and a (slower) cross-type bandwidth.
    """

    devices: List[Device]
    cross_type_bw: float = DEFAULT_CROSS_TYPE_BW

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(spec: Sequence[Tuple[str, int]],
              cross_type_bw: float = DEFAULT_CROSS_TYPE_BW) -> "Cluster":
        """Build a cluster from [(profile_name, count), ...]."""
        devices: List[Device] = []
        node = 0
        idx = 0
        for name, count in spec:
            prof = PROFILES[name]
            per = prof.devices_per_node
            remaining = count
            while remaining > 0:
                take = min(per, remaining)
                for _ in range(take):
                    devices.append(Device(index=idx, profile=prof, node=node))
                    idx += 1
                node += 1
                remaining -= take
        return Cluster(devices=devices, cross_type_bw=cross_type_bw)

    # ----------------------------------------------------------------- access
    def __len__(self) -> int:
        return len(self.devices)

    @property
    def type_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.devices:
            out[d.type_name] = out.get(d.type_name, 0) + 1
        return out

    @property
    def types(self) -> List[DeviceProfile]:
        seen: Dict[str, DeviceProfile] = {}
        for d in self.devices:
            seen.setdefault(d.type_name, d.profile)
        return list(seen.values())

    def devices_of_type(self, name: str) -> List[Device]:
        return [d for d in self.devices if d.type_name == name]

    def nodes_of_type(self, name: str) -> Dict[int, List[Device]]:
        out: Dict[int, List[Device]] = {}
        for d in self.devices_of_type(name):
            out.setdefault(d.node, []).append(d)
        return out

    def link_bw(self, a: Device, b: Device) -> float:
        """Unidirectional bandwidth of the (a, b) edge, bytes/s."""
        if a.index == b.index:
            return 0.0
        if a.node == b.node:
            return a.profile.intra_bw
        if a.type_name == b.type_name:
            return a.profile.inter_bw
        return self.cross_type_bw

    # ------------------------------------------------------------- aggregates
    def total_flops(self, devices: Optional[Sequence[Device]] = None) -> float:
        devs = self.devices if devices is None else devices
        return sum(d.profile.flops for d in devs)

    def total_hbm_bw(self, devices: Optional[Sequence[Device]] = None) -> float:
        devs = self.devices if devices is None else devices
        return sum(d.profile.hbm_bw for d in devs)

    def total_price(self, devices: Optional[Sequence[Device]] = None) -> float:
        devs = self.devices if devices is None else devices
        return sum(d.profile.price_per_hour for d in devs)

    def aggregate_link_bw(self, devices: Sequence[Device]) -> float:
        """Sum of pairwise link bandwidths inside a device subset (Eq. 3 term)."""
        return sum(self.link_bw(a, b)
                   for a, b in itertools.combinations(devices, 2))

    def subset(self, indices: Sequence[int]) -> List[Device]:
        by_idx = {d.index: d for d in self.devices}
        return [by_idx[i] for i in indices]


# --- Canonical clusters from the paper's evaluation --------------------------
def paper_homogeneous_h800(n: int = 32) -> Cluster:
    return Cluster.build([("H800", n)])


def paper_homogeneous_h20(n: int = 88) -> Cluster:
    return Cluster.build([("H20", n)])


def paper_heterogeneous(n_h800: int = 24, n_h20: int = 24) -> Cluster:
    return Cluster.build([("H800", n_h800), ("H20", n_h20)])


def tpu_heterogeneous(n_v5p: int = 64, n_v5e: int = 256) -> Cluster:
    return Cluster.build([("TPUv5p", n_v5p), ("TPUv5e", n_v5e)])
