"""Mixture-of-Experts with GShard-style dense dispatch.

Top-k routing with capacity, as the reference computes it:

    router logits (fp32) -> top-k gates -> capacity-limited position-in-
    expert via causal cumulative sum -> dispatch one-hot (g, s, E, C) ->
    expert_in = einsum(dispatch, x) -> per-expert FFN -> combine.

``impl="gather"`` replaces the two dispatch/combine einsums with index
scatters and gathers (same capacity semantics).  The expert products are
batched matrix products (``torch.einsum``), as the reference leaves them
to XLA.

Capacity semantics (decode/prefill parity), kept from the reference:

* **Token-major serialization** — a token's slot in an expert depends only
  on *earlier* tokens' loads.
* **Config-static capacity** — capacity derives from ``group_size``, never
  from the runtime group length, so a 1-token decode step and a full-
  sequence pass agree on the drop threshold.
* **Per-row groups** — dispatch groups never span batch rows.

Incremental decode carries per-expert usage ``counts (B, E)`` in the layer
cache (reset every ``group_size`` tokens — the full pass's chunk boundary)
and reproduces the full pass's drops exactly.

Sharding (``rules``): the route follows where ``shard_tree`` put the
expert weights.  Dispatch groups never span batch rows, so each rank
routes its own rows exactly as the unsharded layer does (the same gating,
positions, capacity, drops and ``counts`` over all E experts), through
``local_map``, and computes only its share of the experts' products:

* **EP** (``"expert"`` on the model axis: the expert dim of ``w1``,
  ``w2`` and ``w3`` sharded there): a rank scatters its rows into, and
  combines them from, only its E/m experts' buffers;
* **TP inside experts** (``"expert_ff"`` on the model axis, as
  ``launch.plans.rules_for`` sets where E does not divide it): every
  expert's buffer, a rank's ``expert_ff``/m columns of ``w1``/``w3`` and
  rows of ``w2``;
* neither: the weights are whole on the axis and every rank computes
  every expert for its rows.

Tokens are replicated over the model axis (the residual stream's
layout), so both routes' outputs are partial sums over it (DTensor
``Partial``), reduced where the caller lays the branch out as the
residual stream; the shared expert's row-parallel product (``act_ff``
on the model axis, as the reference constrains it) joins the same sum.
No expert weight is gathered.  Wire bytes a MoE layer, per chip, for
(B/d) rows of S tokens on a rank's data shard and m model ranks: one
all-reduce of the (B/d, S, D) output in the compute dtype forward,
2(m-1)/m of its bytes, and one of the input's gradient backward (the
reference's cost model prices an all-to-all of the top-k dispatched
tokens instead).
"""

from __future__ import annotations

import torch

from ..distributed import (
    constrain,
    is_dtensor,
    logical_spec,
    placements,
)
from .config import ArchConfig, MoEConfig
from .layers import gelu, param, sigmoid, silu


def moe_init(gen: torch.Generator, cfg: ArchConfig, m: MoEConfig) -> dict:
    D, Fe, E = cfg.d_model, m.expert_d_ff, m.num_experts
    dt = cfg.pdtype()
    glu = cfg.activation == "swiglu"
    w_in = ("expert", "d_model", "expert_ff")
    p = {
        "router": param(gen, (D, E), ("d_model", None), dt),
        "w1": param(gen, (E, D, Fe), w_in, dt),
        "w2": param(gen, (E, Fe, D), ("expert", "expert_ff", "d_model_out"),
                    dt),
    }
    if glu:
        p["w3"] = param(gen, (E, D, Fe), w_in, dt)
    if m.shared_d_ff:
        p["shared_w1"] = param(gen, (D, m.shared_d_ff), ("d_model", "d_ff"),
                               dt)
        p["shared_w2"] = param(gen, (m.shared_d_ff, D),
                               ("d_ff", "d_model_out"), dt)
        if glu:
            p["shared_w3"] = param(gen, (D, m.shared_d_ff),
                                   ("d_model", "d_ff"), dt)
        p["shared_gate"] = param(gen, (D, 1), ("d_model", None), dt)
    return p


def _top_k_gating(logits: torch.Tensor, m: MoEConfig):
    """logits: (g, s, E) fp32 -> gates (g, s, E) with exactly top_k nonzero,
    normalized over the selected experts, and the choices' one-hots (g, s,
    k, E).  Ties go to the lower expert index, as ``jax.lax.top_k`` breaks
    them (a stable descending sort; ``torch.topk`` promises no order)."""
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :m.top_k], topi[..., :m.top_k]
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    gates = torch.zeros_like(probs).scatter(-1, topi, topv)
    # one-hots by comparison: ``one_hot`` reads the ids' range back to the
    # host on a CPU tensor
    experts = torch.arange(logits.shape[-1], device=logits.device)
    oh = (topi[..., None] == experts).to(probs.dtype)
    return gates, oh


def expert_capacity(m: MoEConfig) -> int:
    """Config-static per-expert capacity: derived from ``group_size`` (not
    the runtime group length) so a decode step and a full-sequence pass
    agree on when a token overflows."""
    cap = int(m.group_size * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to multiple of 8


def _expert_positions(oh: torch.Tensor, base: torch.Tensor | None):
    """Causal (token-major) position-in-expert.

    ``oh: (g, s, k, E)`` one-hot choices; ``base: (g, E)`` prior loads
    carried in from a decode cache.  Returns ``(assign (g,s,E), pos
    (g,s,E), loads (g,E))``, where ``loads`` counts every assignment (kept
    or dropped)."""
    assign = oh.sum(dim=2)  # (g, s, E) in {0, 1}
    pos = torch.cumsum(assign, dim=1) - assign  # exclusive prefix loads
    if base is not None:
        pos = pos + base[:, None, :].to(pos.dtype)
    loads = pos[:, -1] + assign[:, -1]  # (g, E) total after the group
    return assign, pos, loads


def _dispatch_tensors(gates: torch.Tensor, oh: torch.Tensor, capacity: int,
                      base: torch.Tensor | None = None,
                      experts: slice | None = None):
    """Dense dispatch. Returns combine (g,s,E,C), dispatch (same shape),
    and the per-group expert loads (g,E).  ``experts`` (a range of expert
    ids) keeps only those experts' columns of combine and dispatch; the
    loads are every expert's."""
    assign, pos, loads = _expert_positions(oh, base)
    if experts is not None:
        gates, assign, pos = (t[..., experts] for t in (gates, assign, pos))
    keep = (pos < capacity) & (assign > 0)
    slots = torch.arange(capacity, dtype=pos.dtype, device=pos.device)
    disp = ((pos[..., None] == slots) & keep[..., None]).to(gates.dtype)
    comb = gates[..., None] * disp
    return comb, disp, loads


def _gather_dispatch(xt, gates, oh, capacity: int,
                     base: torch.Tensor | None = None,
                     experts: slice | None = None):
    """Scatter/gather token routing: the kept (token, choice) rows are
    written to their (expert, slot) and read back, O(s*k*D) where the dense
    einsums are O(s*E*C*D).  Returns (expert_in (g,E,C,D), combine_fn(eout)
    -> (g,s,D), loads (g,E)).  ``experts`` (a range of expert ids) keeps
    only the choices of those experts: ``expert_in`` holds their buffers
    and the combine reads only them; the loads are every expert's.

    Every choice is written, a dropped one to a row past the buffers that
    is then cut off (the reference's ``mode="drop"``), so no size depends
    on the routing and the host reads nothing."""
    g, s, k, E = oh.shape
    D = xt.shape[-1]
    _, pos_e, loads = _expert_positions(oh, base)
    topi = oh.argmax(dim=-1)  # (g, s, k) expert ids
    pos = torch.gather(pos_e, -1, topi).to(torch.int64)
    keep = pos < capacity  # (g, s, k)
    n, slot = E, topi  # the buffers' expert index of each choice
    if experts is not None:
        n, slot = experts.stop - experts.start, topi - experts.start
        keep = keep & (slot >= 0) & (slot < n)
        slot = slot.clamp(0, n - 1)
    gidx = torch.arange(g, device=xt.device)[:, None, None]
    # flat row of each choice in the (g, n, capacity) buffers; the dropped
    # choices all go to the extra row g * n * capacity
    row = torch.where(keep, (gidx * n + slot) * capacity + pos,
                      g * n * capacity)
    flat = xt.new_zeros((g * n * capacity + 1, D))
    flat.index_copy_(0, row.reshape(-1),
                     xt[:, :, None, :].expand(g, s, k, D).reshape(-1, D))
    expert_in = flat[:-1].view(g, n, capacity, D)
    gate_k = torch.gather(gates, -1, topi)  # (g, s, k)

    def combine(eout):
        y_k = eout[gidx, slot, pos.clamp_max(capacity - 1)]  # (g,s,k,D)
        wk = (gate_k * keep).to(eout.dtype)[..., None]
        return (y_k * wk).sum(dim=2)

    return expert_in, combine, loads


def _routed(p: dict, cfg: ArchConfig, m: MoEConfig, x: torch.Tensor,
            counts: torch.Tensor | None, pos, return_counts: bool,
            experts: slice | None = None):
    """The routed experts' output (B, S, D), and with ``return_counts``
    the counts (B, E) after the last chunk.  ``p["w1"]``, ``p["w2"]`` (and ``p["w3"]``) hold the
    experts ``experts`` (all of them by default) or a slice of every
    expert's ``expert_ff``; the router is whole, so the routing is the
    unsharded layer's."""
    B, S, D = x.shape
    # Per-row groups: a dispatch group never spans batch rows, so decode
    # (one group per row) and the full pass agree on group membership.
    gs = min(m.group_size, S)
    if S % gs:
        raise ValueError(
            f"moe: sequence length {S} must be <= group_size "
            f"({m.group_size}) or a multiple of it; pad the sequence or "
            f"adjust MoEConfig.group_size")
    g = B * S // gs
    xt = x.reshape(g, gs, D)
    logits = (xt @ p["router"].to(xt.dtype)).float()
    gates, oh = _top_k_gating(logits, m)
    capacity = expert_capacity(m)
    base = None
    if counts is not None:
        # decode step (S == 1, g == B): a chunk boundary resets the loads,
        # where the full pass starts a fresh dispatch group (the reference's
        # where(fresh, 0, counts), on the device for a tensor ``pos``)
        base = (counts * (pos % m.group_size != 0)).float()
    if cfg.moe_impl == "gather":
        ein, combine_fn, loads = _gather_dispatch(xt, gates, oh, capacity,
                                                  base, experts)
    else:
        comb, disp, loads = _dispatch_tensors(gates, oh, capacity, base,
                                              experts)
        comb = comb.to(x.dtype)
        ein = torch.einsum("gsec,gsd->gecd", disp.to(x.dtype), xt)
        combine_fn = lambda eout: torch.einsum(  # noqa: E731
            "gsec,gecd->gsd", comb, eout)
    w1 = p["w1"].to(x.dtype)
    w2 = p["w2"].to(x.dtype)
    if cfg.activation == "swiglu":
        w3 = p["w3"].to(x.dtype)
        h = silu(torch.einsum("gecd,edf->gecf", ein, w1)) * torch.einsum(
            "gecd,edf->gecf", ein, w3)
    else:
        h = gelu(torch.einsum("gecd,edf->gecf", ein, w1))
    eout = torch.einsum("gecf,efd->gecd", h, w2)
    y = combine_fn(eout).reshape(B, S, D)
    if not return_counts:
        return y
    # loads after each row's LAST chunk — the state a later decode step
    # needs (earlier chunks' loads are dead: their boundary passed)
    E = loads.shape[-1]
    counts_out = loads.reshape(B, S // gs, E)[:, -1].to(torch.int32)
    return y, counts_out


def _shared(p: dict, cfg: ArchConfig, x: torch.Tensor, rules=None):
    """The shared expert times its sigmoid gate (on DTensors, a
    row-parallel product: a partial sum over the ``act_ff`` axes)."""
    if cfg.activation == "swiglu":
        hs = silu(x @ p["shared_w1"]) * (x @ p["shared_w3"])
    else:
        hs = gelu(x @ p["shared_w1"])
    hs = constrain(hs, rules, "batch", None, "act_ff")
    shared = hs @ p["shared_w2"]
    sg = sigmoid((x @ p["shared_gate"]).float())
    return shared * sg.to(x.dtype)


_EXPERT_DIMS = {"w1": (0, 2), "w3": (0, 2), "w2": (0, 1)}  # (expert, ff)


def _moe_sharded(p: dict, cfg: ArchConfig, m: MoEConfig, x, rules, counts,
                 pos, return_counts: bool):
    """The routed experts on each rank's batch rows and its share of the
    experts (the module docstring's routes), the shared expert on
    DTensors.  The output is partial over the route's mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    spec = logical_spec(rules, ("batch", None, None), tuple(x.shape))
    x_pl = placements(mesh, spec)
    c_pl = placements(mesh, (spec[0], None))
    split = [q.is_shard() for q in x_pl]  # mesh dims that split the rows
    w1_pl = p["w1"].placements
    ep = [i for i, q in enumerate(w1_pl) if q == Shard(0) and not split[i]]
    tp = [i for i, q in enumerate(w1_pl) if q == Shard(2) and not split[i]]
    route = set(ep + tp)
    rep, part = Replicate(), Partial()

    def grads_of(pl):  # a whole input's gradient is partial where split
        return [q if q.is_shard() else
                (part if split[i] or i in route else rep)
                for i, q in enumerate(pl)]

    names = [k for k in ("w1", "w2", "w3") if k in p]
    in_pl = [x_pl, [rep] * mesh.ndim]
    for k in names:
        e_dim, f_dim = _EXPERT_DIMS[k]
        in_pl.append([Shard(e_dim) if i in ep else Shard(f_dim) if i in tp
                      else rep for i in range(mesh.ndim)])
    args = [w.redistribute(mesh, pl) for w, pl in
            zip([x, p["router"]] + [p[k] for k in names], in_pl)]
    grads = [[part if i in route else q for i, q in enumerate(x_pl)]]
    grads += [grads_of(pl) for pl in in_pl[1:]]
    if counts is not None:
        args.append(counts.redistribute(mesh, c_pl))
        in_pl.append(c_pl)
        grads.append(c_pl)
    experts = None
    if ep:  # this rank's experts: its index over the EP dims, major first
        idx, ways, coord = 0, 1, mesh.get_coordinate()
        for i in ep:
            idx = idx * mesh.size(i) + coord[i]
            ways *= mesh.size(i)
        n_l = p["w1"].shape[0] // ways
        experts = slice(idx * n_l, (idx + 1) * n_l)
    y_pl = [part if i in route else q for i, q in enumerate(x_pl)]

    def local(x_l, router, *rest):
        p_l = {"router": router, **dict(zip(names, rest))}
        c_l = rest[len(names)] if counts is not None else None
        return _routed(p_l, cfg, m, x_l, c_l, pos, return_counts, experts)

    out = local_map(
        local, out_placements=(y_pl, c_pl) if return_counts else y_pl,
        in_placements=tuple(in_pl), in_grad_placements=tuple(grads),
        device_mesh=mesh)(*args)
    y, counts_out = out if return_counts else (out, None)
    if m.shared_d_ff:
        y = y + _shared(p, cfg, x, rules)
    return (y, counts_out) if return_counts else y


def moe(p: dict, cfg: ArchConfig, m: MoEConfig, x: torch.Tensor,
        rules=None, counts: torch.Tensor | None = None,
        pos=None, return_counts: bool = False):
    """x: (B, S, D) -> (B, S, D), or ``(y, counts)`` with
    ``return_counts=True``.

    ``counts: (B, E)`` are prior per-expert loads from a decode cache
    (single-token steps); ``pos`` is the step's global position (an ``int``
    or a 0-d integer tensor on ``x``'s device), used to reset the loads at
    ``group_size`` chunk boundaries.  The returned
    counts are the loads after this call's last chunk, ready to cache.
    With rules on DTensors, ``y`` is a partial sum over the mesh dims
    that shard the expert weights (the module docstring).
    """
    if rules is not None and is_dtensor(x):
        return _moe_sharded(p, cfg, m, x, rules, counts, pos, return_counts)
    out = _routed(p, cfg, m, x, counts, pos, return_counts)
    y, counts_out = out if return_counts else (out, None)
    if m.shared_d_ff:
        y = y + _shared(p, cfg, x)
    return (y, counts_out) if return_counts else y
