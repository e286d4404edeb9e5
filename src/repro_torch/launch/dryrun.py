"""Multi-pod dry-run: run every (architecture x input shape) cell's step
once on the production mesh, on ``meta`` tensors, and record the memory,
the FLOPs and bytes per chip and the collective schedule for the roofline.

The production mesh (``launch.mesh``) lies over a fake process group of 256
or 512 ranks in this one process; parameters, optimizer state, caches and
inputs are ``meta`` DTensors laid out by the plan's sharding rules, so no
tensor is allocated and no device is touched.  The step runs under a
dispatch mode that sees every local op of rank 0 (DTensor desugars each
op into local ops and collectives first):

* FLOPs per chip: ``torch.utils.flop_counter``'s formulas on the local
  shapes; the recurrences' shape-only ``meta`` route counts nothing and
  ``roofline.ssm_scan_correction`` adds their work back, as the
  reference does;
* bytes per chip: every non-view op's local inputs read and outputs
  written once (eager, unfused: an upper bound of what a fused program
  moves);
* collectives: each ``_c10d_functional`` op's local bytes and group size,
  with ``roofline``'s ring factors;
* memory per chip: the sharded arguments and outputs, less the outputs
  that alias an argument, plus the peak of live local bytes during the
  step.

Divergences from the reference: no XLA compile (``compile_s`` is the
traced run's seconds), and every layer runs, so there is no 1- and
2-unit extrapolation.  The MoE layers run the plan's expert sharding
(``nn.moe``: EP where the experts shard the model axis, TP inside the
experts where ``rules_for`` moves it to ``expert_ff``), but combine the
experts' outputs with an all-reduce of partial sums where the
reference's cost model prices an all-to-all.  A MoE cell's artifact
says ``"expert_parallel": true`` when its expert weights are sharded on
the mesh (``false`` where the plan keeps them whole; ``null`` for a
model without experts) and adds ``"moe"``: the route, rank 0's local
and the global bytes of the expert weights, and the all-gathers of an
expert weight over the model axis (none).  Nothing happens at import.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all                # 32 cells, 1 pod
    python -m repro_torch.launch.dryrun --all --multi-pod    # 32 cells, 2 pods
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, all_cells, cache_axes, get_config, input_specs
from ..configs import runnable
from ..distributed import (
    COLLECTIVE_KINDS,
    is_dtensor,
    mesh_axis_names,
    mesh_sizes,
    shard_tree,
)
from ..nn import abstract_params, param_axes
from ..nn.model import tree_leaves
from ..serving.steps import make_decode_step, make_prefill_step
from ..training import (
    AdamConfig,
    TrainStepConfig,
    abstract_opt_state,
    make_train_step,
)
from .mesh import make_production_mesh
from .plans import Plan, apply_plan, baseline_plan, rules_for
from .roofline import (
    CollectiveStats,
    model_flops_for,
    roofline_terms,
    ssm_scan_correction,
)

def _group(args):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1])


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """On-wire bytes per chip of one collective with ``parse_collectives``'
    ring factors (``nbytes``: the op's result, a reduce-scatter's small
    piece)."""
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    return nbytes  # collective-permute


class StepCounter(TorchDispatchMode):
    """Counts rank 0's local work under DTensor: FLOPs, bytes accessed,
    collectives and the peak of live bytes.  An op on DTensors is passed
    on (``NotImplemented``) so DTensor desugars it into local ops and
    collectives, which come back here; the ops DTensor runs on fake
    tensors of the global shapes to propagate shapes are not work, and
    are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.coll = CollectiveStats()
        self.gathers: list[tuple[tuple, str]] = []  # (input shape, group)
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        names = {t.__name__ for t in types}
        if "DTensor" in names:
            return NotImplemented
        out = func(*args, **kwargs)
        if "FakeTensor" in names:
            return out
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                nbytes = float(out.nbytes)
                group = _group(args)
                g = max(group.size(), 1)
                if kind == "all-gather":
                    self.gathers.append((tuple(args[0].shape),
                                         group.group_name))
                w = wire_bytes(kind, nbytes, g)
                st = self.coll
                st.wire_bytes += w
                st.payload_bytes += nbytes
                st.counts[kind] = st.counts.get(kind, 0) + 1
                st.by_kind_bytes[kind] = st.by_kind_bytes.get(kind, 0.0) + w
            return out
        self.ops += 1
        fn = self._flop_registry.get(packet)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        if func.is_view or func._schema.is_mutable:
            return out
        outs = [o for o in (out if isinstance(out, (tuple, list))
                            else (out,)) if isinstance(o, torch.Tensor)]
        ins = [a for a in list(args) + list(kwargs.values())
               if isinstance(a, torch.Tensor)]
        self.bytes += sum(float(t.nbytes) for t in ins + outs)
        for o in outs:
            n = int(o.nbytes)
            self.live += n
            weakref.finalize(o, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if is_dtensor(t) else t
            total += int(local.nbytes)
    return total


def _storages(tree) -> set:
    return {(t.to_local() if is_dtensor(t) else t).untyped_storage()._cdata
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def _expert_weights(params, axes) -> list:
    """The leaves whose logical axes name ``"expert"``, with their axes."""
    out = []
    if isinstance(params, dict):
        for k in params:
            out += _expert_weights(params[k], axes[k])
    elif isinstance(params, (list, tuple)):
        for p, a in zip(params, axes):
            out += _expert_weights(p, a)
    elif axes is not None and "expert" in axes:
        out.append((params, axes))
    return out


def _moe_record(params, axes, batch_axes) -> tuple[dict, set, set]:
    """A MoE cell's ``"moe"`` record (the route its expert weights take,
    rank 0's local and the global bytes of them), the local shapes an
    all-gather of one of them would take as input (at rest, and whole on
    the batch axes after the FSDP gather) and the groups of the mesh axes
    outside the batch's."""
    weights = _expert_weights(params, axes)
    mesh = weights[0][0].device_mesh
    names = mesh_axis_names(mesh)
    routes, shapes, local, whole = set(), set(), 0, 0
    for w, ax in weights:
        loc = w.to_local()
        local += int(loc.nbytes)
        whole += w.numel() * w.element_size()
        shapes.add(tuple(loc.shape))
        gathered = list(w.shape)
        for i, pl in enumerate(w.placements):
            if pl.is_shard() and names[i] not in batch_axes:
                gathered[pl.dim] //= mesh.size(i)
                routes.add({"expert": "ep", "expert_ff": "tp"}.get(
                    ax[pl.dim], ax[pl.dim]))
        shapes.add(tuple(gathered))
    groups = {mesh.get_group(a).group_name for a in names
              if a not in batch_axes}
    rec = {"route": "+".join(sorted(routes)) or "whole",
           "expert_bytes_local": local, "expert_bytes_global": whole}
    return rec, shapes, groups


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               plan: Plan | None = None, mesh=None):
    """Build one cell: its sharded step and its ``meta`` arguments.
    Returns (cfg, shape, step, args, meta).  A MoE cell's ``meta`` holds
    the private ``"_experts"``: the local shapes of its expert weights
    and the groups of the mesh axes outside the batch's
    (``_moe_record``), which :func:`run_cell` pops."""
    cfg0 = get_config(arch)
    shape = SHAPES[shape_name]
    if not runnable(cfg0, shape):
        raise ValueError(f"{arch} x {shape_name} is a skipped cell "
                         "(full attention at 500k)")
    t0 = time.perf_counter()
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    plan = plan or baseline_plan(cfg0, shape)
    cfg = apply_plan(cfg0, plan)
    rules = rules_for(cfg, shape, mesh, plan)

    p_axes = param_axes(cfg)
    params = shard_tree(rules, abstract_params(cfg), p_axes)
    specs = input_specs(cfg, shape)
    batch = shard_tree(rules, specs["batch"], {
        k: ("batch",) + (None,) * (v.dim() - 1)
        for k, v in specs["batch"].items()})

    if shape.kind == "train":
        adam = AdamConfig(state_dtype=plan.state_dtype)
        step = make_train_step(
            cfg, TrainStepConfig(adam=adam, microbatches=plan.microbatches,
                                 grad_reduce_dtype=plan.grad_reduce_dtype),
            rules, param_axes=p_axes)
        opt = abstract_opt_state(abstract_params(cfg), adam)
        opt = shard_tree(rules, opt, {"mu": p_axes, "nu": p_axes,
                                      "count": None})
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, rules, max_seq=shape.seq_len)
        args = (params, batch)
    else:  # decode: the new token at the cache's last position
        step = make_decode_step(cfg, rules)
        cache = shard_tree(rules, specs["cache"], cache_axes(cfg, shape))
        args = (params, cache, batch, shape.seq_len - 1)
    sizes = mesh_sizes(mesh)
    chips = 1
    for n in sizes.values():
        chips *= n
    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "expert_parallel": None,
        "plan": {f: getattr(plan, f) for f in plan.__dataclass_fields__},
    }
    if cfg.moe is not None:
        meta["moe"], *meta["_experts"] = _moe_record(
            params, p_axes, rules.physical("batch"))
        meta["expert_parallel"] = meta["moe"]["route"] != "whole"
    meta["lower_s"] = time.perf_counter() - t0
    return cfg, shape, step, args, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             plan: Plan | None = None, mesh=None, tag: str = "") -> dict:
    """Run one cell's step once under :class:`StepCounter` and write its
    artifact (the reference's keys) to ``out_dir``."""
    cfg, shape, step, args, meta = lower_cell(arch, shape_name, multi_pod,
                                              plan, mesh)
    experts = meta.pop("_experts", None)
    mesh = mesh or next(t for t in tree_leaves(args[0])).device_mesh
    counter = StepCounter()
    t0 = time.perf_counter()
    with counter:
        out = step(*args)
    meta["compile_s"] = time.perf_counter() - t0
    if experts is not None:
        shapes, groups = experts
        meta["moe"]["expert_gathers"] = sum(
            1 for shp, grp in counter.gathers
            if shp in shapes and grp in groups)
    arg_b = _local_bytes(args)
    out_b = _local_bytes(out)
    in_st = _storages(args)
    alias_b = sum(
        int((t.to_local() if is_dtensor(t) else t).nbytes)
        for t in tree_leaves(out) if isinstance(t, torch.Tensor)
        and (t.to_local() if is_dtensor(t) else t).untyped_storage()._cdata
        in in_st)
    mem_d = {"argument_bytes": arg_b, "output_bytes": out_b,
             "temp_bytes": counter.peak, "generated_code_bytes": 0,
             "alias_bytes": alias_b}
    mem_d["total_bytes_per_device"] = arg_b + out_b + counter.peak - alias_b

    chips = meta["chips"]
    xf, xb = ssm_scan_correction(cfg, shape, mesh_sizes(mesh))
    flops, nbytes = counter.flops, counter.bytes
    coll = counter.coll
    rf = roofline_terms({"flops": flops + xf, "bytes accessed": nbytes + xb},
                        coll, chips, model_flops=model_flops_for(cfg, shape))
    rec = {
        **meta,
        "memory": mem_d,
        "cost": {"flops": flops + xf, "bytes_accessed": nbytes + xb,
                 "ssm_correction_flops": xf, "ssm_correction_bytes": xb,
                 "raw_full_flops": flops, "probe_compile_s": 0.0},
        "collectives": {
            "wire_bytes_per_chip": coll.wire_bytes,
            "payload_bytes": coll.payload_bytes,
            "counts": coll.counts,
            "by_kind_wire_bytes": coll.by_kind_bytes,
            "raw_full_wire_bytes": coll.wire_bytes,
        },
        "roofline": rf.to_dict(),
        "hlo_bytes": 0,
        "local_ops": counter.ops,
    }
    out_p = pathlib.Path(out_dir)
    out_p.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_p / f"{arch}__{shape_name}__{meta['mesh']}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1))
    r = rec["roofline"]
    print(f"[dryrun] {arch:18s} {shape_name:12s} {meta['mesh']:8s} "
          f"run={meta['compile_s']:6.1f}s "
          f"C={r['compute_s']:.3f}s M={r['memory_s']:.3f}s "
          f"N={r['collective_s']:.3f}s -> {r['bottleneck']} "
          f"useful={r['useful_ratio']:.2f}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for mp in meshes:
        mesh = make_production_mesh(multi_pod=mp)
        for arch, shape_name in cells:
            mesh_tag = "2x16x16" if mp else "16x16"
            path = pathlib.Path(
                args.out) / f"{arch}__{shape_name}__{mesh_tag}.json"
            if args.skip_existing and path.exists():
                print(f"[dryrun] skip existing {path.name}")
                continue
            try:
                run_cell(arch, shape_name, mp, args.out, mesh=mesh)
            except Exception as e:  # noqa: BLE001 — reported and counted
                traceback.print_exc()
                failures.append((arch, shape_name, mp, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
