"""Roofline-term extraction from compiled dry-run artifacts.

Three terms per (arch x shape x mesh), in seconds, for the fleet a plan is
costed for (a :class:`FleetSpec`; the default is the reference's TPU v5e
fleet):

    compute    = HLO_FLOPs / (chips * peak_flops)
    memory     = HLO_bytes / (chips * hbm_bw)
    collective = wire_bytes_per_chip / ici_bw-per-link

``HLO_FLOPs`` / ``HLO_bytes`` come from an artifact's cost analysis (which
reports per-partition totals under SPMD — multiply by chips to get the
global count, divide back for the per-chip term).  Collective bytes are
NOT in the cost analysis: :func:`parse_collectives` reads the post-SPMD
HLO text and sums per-op wire traffic with ring-algorithm factors:

    all-reduce(N)          -> 2N(g-1)/g     on-wire per chip
    all-gather(out N)      -> N(g-1)/g
    reduce-scatter(in N)   -> N(g-1)/g
    all-to-all(N)          -> N(g-1)/g
    collective-permute(N)  -> N

with g = replica-group size parsed per op.  Shapes in the partitioned
module are already per-chip.  The parser is the reference's, verbatim:
it reads HLO text that the reference's dry-run wrote.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """The hardware of the fleet being planned: per-chip peak rate, memory
    rate, interconnect rate per link, price and memory size.  The planner
    and :func:`roofline_terms` take it as a parameter.

    The defaults are the reference's constants for a TPU v5e fleet
    (``src/repro/launch/roofline.py:31-33`` and
    ``src/repro/planner/cost_model.py:32-33``), kept so that plans and
    roofline terms equal the reference's.  They describe the planned
    fleet, not the device this package runs on."""

    peak_flops: float = 197e12         # bf16 FLOP/s per chip
    hbm_bw: float = 819e9              # bytes/s per chip
    ici_bw: float = 50e9               # bytes/s per link
    chip_cost_per_s: float = 1.2 / 3600.0  # $/chip-second (on-demand proxy)
    hbm_bytes: float = 16e9            # HBM per chip


# the reference's fleet, and its constants under the reference's names
TPU_V5E = FleetSpec()
PEAK_FLOPS = TPU_V5E.peak_flops
HBM_BW = TPU_V5E.hbm_bw
ICI_BW = TPU_V5E.ici_bw

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0, "c128": 16,
}

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# e.g.  %all-gather.3 = bf16[2,4096,512]{2,1,0} all-gather(...)
_RE_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")
_RE_OP = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+\[[\d,]*\](?:\{[^}]*\})?))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_RE_GROUPS = re.compile(r"replica_groups=\{\{([^}]*)\}")
_RE_GROUPS_IOTA = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _RE_SHAPE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _RE_GROUPS_IOTA.search(line)
    if m:  # iota form [num_groups,group_size]
        return int(m.group(2))
    m = _RE_GROUPS.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0           # per-chip on-wire bytes (ring model)
    payload_bytes: float = 0.0        # raw summed operand/result sizes
    counts: dict = dataclasses.field(default_factory=dict)
    by_kind_bytes: dict = dataclasses.field(default_factory=dict)


def parse_collectives(hlo_text: str, default_group: int) -> CollectiveStats:
    """Per-chip wire bytes of every collective op in post-SPMD HLO text
    (``default_group`` where an op names no replica groups)."""
    st = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _RE_OP.search(line)
        if not m:
            continue
        shape_str = m.group(1) or m.group(2)
        kind = m.group(3)
        nbytes = _shape_bytes(shape_str)
        g = max(_group_size(line, default_group), 1)
        if kind == "all-reduce":
            wire = 2 * nbytes * (g - 1) / g
        elif kind in ("all-gather", "all-to-all"):
            wire = nbytes * (g - 1) / g
        elif kind == "reduce-scatter":
            # result shape is the scattered (small) piece; input is g*N
            wire = nbytes * (g - 1)
        else:  # collective-permute
            wire = nbytes
        st.wire_bytes += wire
        st.payload_bytes += nbytes
        st.counts[kind] = st.counts.get(kind, 0) + 1
        st.by_kind_bytes[kind] = st.by_kind_bytes.get(kind, 0.0) + wire
    return st


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(cost: dict, coll: CollectiveStats, chips: int,
                   model_flops: float = 0.0,
                   fleet: FleetSpec = TPU_V5E) -> Roofline:
    """The three per-chip terms of one compiled cell on ``fleet`` and the
    largest of them (the bottleneck)."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / fleet.peak_flops
    memory_s = nbytes / fleet.hbm_bw
    collective_s = coll.wire_bytes / fleet.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * chips
    return Roofline(
        flops_per_chip=flops,
        hbm_bytes_per_chip=nbytes,
        wire_bytes_per_chip=coll.wire_bytes,
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
    )


def ssm_scan_correction(cfg, shape, mesh_shape: dict) -> tuple[float, float]:
    """Analytic per-chip (extra_flops, extra_hbm_bytes) for the sequential
    time recurrences of RWKV-6 / Mamba.

    A compiler's cost analysis counts a scanned loop body once, not x trip
    count; the layer-loop undercount is fixed by extrapolation (the
    dry-run's), but the *inner* time scans need this analytic correction.
    The dominant cost is the carry living in HBM between iterations (what
    a chunked recurrence kernel removes by keeping its state on chip):

        bytes  ~= steps * 2 * carry_bytes   (read + write per step)
        flops  ~= steps * step_flops

    Train applies a 3x factor (forward + checkpoint recompute + backward
    carries).  Sharding: the carry shards on batch (data axes) for RWKV
    (heads replicated) and on batch x d_inner for Mamba.
    """
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0, 0.0
    data_ways = 1
    for ax in ("pod", "data"):
        data_ways *= mesh_shape.get(ax, 1)
    model_ways = mesh_shape.get("model", 1)
    B = shape.global_batch
    T = shape.seq_len if shape.kind in ("train", "prefill") else 1
    batch_shards = data_ways if B % data_ways == 0 else 1
    factor = 3.0 if shape.kind == "train" else 1.0
    flops = bytes_ = 0.0
    if cfg.family == "ssm":
        r = cfg.rwkv
        H, dh = cfg.d_model // r.head_size, r.head_size
        carry = B * H * dh * dh * 4 / batch_shards     # heads replicated
        step_flops = 5 * B * H * dh * dh / batch_shards
        steps = T * cfg.n_layers
        flops += steps * step_flops * factor
        bytes_ += steps * 2 * carry * factor
    else:  # hybrid: mamba layers only
        h = cfg.hybrid
        m = h.mamba
        din = m.expand * cfg.d_model
        n_mamba = cfg.n_layers * (h.period - 1) // h.period
        din_shards = model_ways if din % model_ways == 0 else 1
        carry = B * din * m.d_state * 4 / (batch_shards * din_shards)
        step_flops = 7 * B * din * m.d_state / (batch_shards * din_shards)
        steps = T * n_mamba
        flops += steps * step_flops * factor
        bytes_ += steps * 2 * carry * factor
    return flops, bytes_


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n_active = cfg.param_count(active_only=True)
    mult = 6.0 if shape.kind == "train" else 2.0
    tokens = shape.tokens if shape.kind in ("train", "prefill") else (
        shape.global_batch)  # decode: one token per sequence
    return mult * n_active * tokens
