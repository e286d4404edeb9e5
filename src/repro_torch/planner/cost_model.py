"""Differentiable analytic roofline model over the plan space.

This is one of the two "learned model" backends the optimizer consumes
(the paper's Ψ): a white-box, differentiable (torch ops, fp32) estimate of
the three roofline terms as a function of the *relaxed* plan knobs.  The
other backend (DNN surrogate trained on traces, ``repro_torch.models``)
plugs into the same MOOProblem interface — the paper's decoupling of
modeling from optimization.

Objectives produced (all minimized):
    latency  — blended roofline step time (partial compute/comm overlap)
    cost     — chip-seconds x $/chip-s
    energy   — proxy: chips x latency x (0.6 + 0.4 * compute_fraction)

plus an HBM-fit term usable as a hard value constraint.

The fleet's rates, price and memory size come from a
:class:`~repro_torch.launch.roofline.FleetSpec` (the reference's TPU v5e
fleet by default).  Every operation works on one relaxed point and under
``torch.func.vmap``/``grad``: no value is read back to the host and no
branch depends on a value.  The order of operations is the reference's, so
the large magnitudes (parameter count x tokens) round as they do there.

The model is *calibrated* against dry-run artifacts: ``calibrate`` fits a
per-(arch, shape) multiplicative fudge on each term from the measured
baseline cell so that napkin math and compiled HLO agree at the baseline
plan.
"""

from __future__ import annotations

import dataclasses

import torch

from ..launch.roofline import TPU_V5E, FleetSpec
from ..nn import ArchConfig, ShapeSpec

# the reference's names for the default fleet's price and memory size
CHIP_COST_PER_S = TPU_V5E.chip_cost_per_s
HBM_BYTES = TPU_V5E.hbm_bytes


# (values, device, dtype) -> the blended choices' values as a tensor, made
# at a program's first (eager) run: a CUDA graph's capture cannot copy a
# constant from the host, so it reuses the one made then
_CHOICES: dict = {}


def _choices(ref: torch.Tensor, values: list) -> torch.Tensor:
    """``ref.new_tensor(values)``, made once per device and dtype."""
    key = (tuple(values), ref.device, ref.dtype)
    t = _CHOICES.get(key)
    if t is None:
        t = _CHOICES[key] = torch.tensor(values, dtype=ref.dtype,
                                         device=ref.device)
    return t


def _maximum(a, b):
    """``jnp.maximum`` with its subgradient (0.5 to each side of a tie)
    where ``a`` is a tensor and ``b`` a number."""
    return torch.maximum(a, a.new_full((), b))


@dataclasses.dataclass
class PlanModel:
    """Callable objective vector F(x) for one (arch, shape) cell."""

    cfg: ArchConfig
    shape: ShapeSpec
    # multiplicative calibration per term (fit vs dry-run artifacts)
    cal_compute: float = 1.0
    cal_memory: float = 1.0
    cal_collective: float = 1.0
    overlap: float = 0.7  # fraction of non-dominant terms hidden by overlap
    fleet: FleetSpec = TPU_V5E

    # ------------------------------------------------------------------
    def _counts(self, soft: dict):
        """Analytic flops/bytes/wire per chip as smooth functions of the
        *soft* (relaxed) knobs. Categorical knobs arrive as convex weights
        over their choices; numeric choices are blended accordingly."""
        cfg, shape = self.cfg, self.shape
        def c(values):
            return _choices(soft["num_chips"], values)

        # --- blended categorical values ------------------------------
        chips = torch.sum(soft["num_chips"] * c([64., 128., 256., 512.]))
        tp = torch.sum(soft["model_parallel"]
                       * c([1., 2., 4., 8., 16., 32.]))
        mb = torch.sum(soft["microbatches"] * c([1., 2., 4., 8.]))
        remat_w = soft["remat"]           # (none, dots, full)
        pdt = soft["param_dtype"] @ c([4.0, 2.0])
        sdt = soft["state_dtype"] @ c([4.0, 2.0])
        cdt = soft["collective_dtype"] @ c([4.0, 2.0])
        moe_gather = soft["moe_impl"] @ c([0.0, 1.0])
        fsdp = soft["fsdp"]
        gcomp = soft["grad_compress"]
        seq_all = soft["seq_shard_all"]

        dp = _maximum(chips / tp, 1.0)
        N = float(cfg.param_count())
        N_act = float(cfg.param_count(active_only=True))
        D, L = float(cfg.d_model), float(cfg.n_layers)
        train = shape.kind == "train"
        tokens = float(shape.tokens if shape.kind in ("train", "prefill")
                       else shape.global_batch)
        B = float(shape.global_batch)
        S = float(shape.seq_len)
        fsdp_on = fsdp > 0.5

        # --- FLOPs per chip -------------------------------------------
        fwd_bwd = 3.0 if train else 1.0
        # remat adds ~1x forward recompute of dots ('dots') or all ('full')
        remat_extra = remat_w @ c([0.0, 0.8, 1.0])
        flops = 2.0 * N_act * tokens * fwd_bwd
        if not cfg.attn_free and shape.kind != "decode":
            flops = flops + (2.0 * tokens * S * 0.5 * cfg.n_heads * cfg.hd
                             * 2.0 * fwd_bwd)
        if shape.kind == "decode" and not cfg.attn_free:
            frac_attn = (1.0 if cfg.hybrid is None
                         else 1.0 / cfg.hybrid.period)
            flops = flops + 2.0 * B * S * cfg.n_heads * cfg.hd * 2.0 * L * frac_attn
        if cfg.moe is not None and train:
            # GShard dispatch/combine einsums: gather impl removes them
            m = cfg.moe
            cap = m.top_k * m.capacity_factor
            disp = 2.0 * tokens * m.num_experts * cap * D * 2.0 * fwd_bwd
            n_moe = L / (cfg.hybrid.moe_period if cfg.hybrid else 1.0)
            flops = flops + disp * (1.0 - moe_gather) * n_moe / L
        flops = flops * (1.0 + (remat_extra if train else 0.0) / 3.0)
        flops_chip = flops / chips

        # --- HBM bytes per chip ---------------------------------------
        act_bytes_tok = 2.0 * D * L * (18.0 if train else 4.0)
        remat_mem_scale = remat_w @ c([1.0, 0.45, 0.25])
        bytes_ = (N / tp / torch.where(fsdp_on, dp, 1.0)) * pdt * (
            4.0 if train else 1.0)
        bytes_ = bytes_ + tokens / chips * act_bytes_tok * remat_mem_scale
        if shape.kind == "decode":
            kv = (2.0 * B * S * cfg.n_kv_heads * cfg.hd * 2.0
                  * (L if cfg.hybrid is None else L / cfg.hybrid.period))
            if cfg.attn_free:
                kv = B * (cfg.d_model / 64.0) * 64.0 * 64.0 * 4.0 * L
            shard = torch.where(seq_all > 0.5, chips, tp)
            bytes_ = bytes_ + kv / torch.minimum(shard * max(B, 1.0),
                                                 chips) / 1.0
        bytes_chip = bytes_

        # --- wire bytes per chip --------------------------------------
        # TP activation all-reduces: ~4/layer fwd(+bwd), ring factor 2
        n_tp_coll = (4.0 + 2.0 * remat_extra) if train else 2.0
        tok_chip = tokens / chips
        wire = n_tp_coll * L * tok_chip * D * 2.0 * 2.0 * (tp - 1.0) / tp
        if train:
            # FSDP param all-gathers: every chip receives its (N/tp)-sized
            # shard-set once per fwd and once per bwd(+remat regather) —
            # per-chip bytes do NOT shrink with dp
            passes = 2.0 + 0.5 * remat_extra
            gather = passes * (N / tp) * pdt * (dp - 1.0) / dp
            reduce = (N / tp) * cdt * (dp - 1.0) / dp
            reduce = reduce * (1.0 - 0.75 * gcomp)  # int8 compression
            wire = wire + torch.where(fsdp_on, gather, 0.0) + reduce
            wire = wire * (1.0 + 0.1 * (mb - 1.0))  # per-microbatch regather
        if cfg.moe is not None:
            # all-to-all of dispatched tokens
            m = cfg.moe
            n_moe_frac = 1.0 / (cfg.hybrid.moe_period if cfg.hybrid else 1.0)
            wire = wire + (2.0 * tok_chip * D * 2.0 * m.top_k
                           * L * n_moe_frac * (2.0 if train else 1.0))
        wire_chip = wire

        # --- HBM peak occupancy (fit constraint) ----------------------
        state_mult = 2.0 * sdt / pdt + 1.0 if train else 1.0
        occ = (N / tp / torch.where(fsdp_on, dp, 1.0)) * pdt * state_mult
        act_live = (tokens / chips / mb) * 2.0 * D * remat_mem_scale * (
            L if train else 1.0)
        occ = occ + act_live
        if shape.kind == "decode":
            kv = (2.0 * B * S * cfg.n_kv_heads * cfg.hd * 2.0
                  * (L if cfg.hybrid is None else L / cfg.hybrid.period))
            occ = occ + kv / chips
        return flops_chip, bytes_chip, wire_chip, occ, chips

    # ------------------------------------------------------------------
    def terms(self, soft: dict):
        """(compute_s, memory_s, collective_s, HBM occupancy, chips)."""
        f, b, w, occ, chips = self._counts(soft)
        compute = f / self.fleet.peak_flops * self.cal_compute
        memory = b / self.fleet.hbm_bw * self.cal_memory
        collective = w / self.fleet.ici_bw * self.cal_collective
        return compute, memory, collective, occ, chips

    def latency(self, soft: dict):
        """The blended roofline step time."""
        c, m, n, _, _ = self.terms(soft)
        stack = torch.stack([c, m, n])
        dom = torch.max(stack)
        return dom + (1.0 - self.overlap) * (torch.sum(stack) - dom)

    def objectives(self, soft: dict) -> torch.Tensor:
        """(latency_s, cost_$, energy) — all minimized."""
        c, m, n, occ, chips = self.terms(soft)
        stack = torch.stack([c, m, n])
        dom = torch.max(stack)
        lat = dom + (1.0 - self.overlap) * (torch.sum(stack) - dom)
        # soft HBM-overflow penalty keeps gradients informative
        over = _maximum(occ / self.fleet.hbm_bytes - 1.0, 0.0)
        lat = lat * (1.0 + 4.0 * over)
        cost = chips * lat * self.fleet.chip_cost_per_s
        energy = chips * lat * (0.6 + 0.4 * c / _maximum(dom, 1e-12))
        return torch.stack([lat, cost, energy])

    def hbm_occupancy(self, soft: dict):
        """Peak HBM bytes per chip (the fit constraint)."""
        _, _, _, occ, _ = self.terms(soft)
        return occ

    # ------------------------------------------------------------------
    def calibrate(self, artifact: dict, baseline_soft: dict) -> "PlanModel":
        """Fit per-term multipliers so the analytic model reproduces the
        dry-run artifact at the baseline plan (paper's model-update loop).
        The multipliers are Python floats."""
        c, m, n, _, _ = self.terms(baseline_soft)
        r = artifact["roofline"]
        return dataclasses.replace(
            self,
            cal_compute=float(r["compute_s"] / _maximum(c, 1e-12)),
            cal_memory=float(r["memory_s"] / _maximum(m, 1e-12)),
            cal_collective=float(
                r["collective_s"] / _maximum(n, 1e-12)),
        )
