"""One rank of the port's multi-rank CPU checks (``tests/test_torch_distributed.py``).

Run as ``python tests/torch_dist_ranks.py RANK WORLD DIR``: every rank joins
a gloo group through ``file://DIR/pg`` and runs the same checks on a
``(4, 2)`` and a ``(2, 4)`` ``("data", "model")`` mesh; rank 0 writes the
readings to ``DIR/result.json``.

* the int8 compressed all-reduce over the ``data`` sub-group;
* a qwen3-4b smoke train step, sharded against the same step unsharded;
* mistral-nemo smoke prefill and decode (the GQA fallback: 2 KV heads on a
  4-wide model axis), rwkv6-3b and Jamba smoke prefill (their recurrences
  through ``local_map``), each sharded against unsharded.  Jamba runs
  three times: in fp32 compute, in bf16 compute without its MoE layers,
  and in its configured bf16 with them, where the sharded run's bf16
  rounding in another order flips some top-k routing choices; that run
  counts the flipped tokens and is repeated with every MoE call's choices
  pinned to the unsharded run's.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(8).reshape(shape),
                      mesh_dim_names=("data", "model"))


def check_psum(mesh) -> dict:
    from repro_torch.distributed import compressed_psum

    g = torch.randn((4, 64), generator=torch.Generator().manual_seed(0))
    coord = mesh.get_coordinate()[0]
    mean, resid = compressed_psum(g[coord], torch.zeros(64),
                                  mesh.get_group("data"))
    err = float((mean - g.mean(0)).abs().max())
    return {"psum_rel_err": err / float(g.abs().max()),
            "resid_norm": float(resid.abs().max())}


def check_train(mesh, arch: str = "qwen3-4b", compute: str | None = None,
                seq: int = 32) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import ShardingRules, shard_tree
    from repro_torch.nn import init_params, param_axes
    from repro_torch.training import (
        AdamConfig,
        TrainStepConfig,
        adam_init,
        make_train_step,
    )

    cfg = get_smoke(arch)
    if compute is not None:
        cfg = cfg.replace(compute_dtype=compute)
    params = init_params(cfg, seed=1, device="cpu")
    batch = {"tokens": torch.arange(4 * seq, dtype=torch.int32).reshape(
        4, seq) % cfg.vocab}
    adam = AdamConfig(lr=1e-2)
    ts = TrainStepConfig(adam=adam)
    p_ref, _, m_ref = make_train_step(cfg, ts)(
        params, adam_init(params, adam), batch)

    rules = ShardingRules(mesh)
    axes = param_axes(cfg)
    params_s = shard_tree(rules, params, axes)
    batch_s = shard_tree(rules, batch, {"tokens": ("batch", None)})
    step = make_train_step(cfg, ts, rules, param_axes=axes)
    p_s, o_s, m_s = step(params_s, adam_init(params_s, adam), batch_s)
    from repro_torch.nn.model import tree_leaves

    delta = max(float((a - _full(b)).abs().max())
                for a, b in zip(tree_leaves(p_ref), tree_leaves(p_s)))
    kept = all(b.placements == c.placements for b, c in
               zip(tree_leaves(p_s), tree_leaves(params_s)))
    return {"loss_plain": float(m_ref["loss"]),
            "loss_sharded": float(m_s["loss"]),
            "grad_norm_plain": float(m_ref["grad_norm"]),
            "grad_norm_sharded": float(m_s["grad_norm"]),
            "param_delta_max": delta, "placements_kept": kept}


def check_serving(mesh, arch: str, decode: bool, **over) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import ShardingRules, shard_tree
    from repro_torch.nn import init_params, param_axes
    from repro_torch.serving import make_decode_step, make_prefill_step

    cfg = get_smoke(arch).replace(**over)
    params = init_params(cfg, seed=0, device="cpu")
    S, B = 24, 2
    toks = (torch.arange(B * S, dtype=torch.int32).reshape(B, S) * 7) \
        % cfg.vocab
    lg_ref, cache_ref = make_prefill_step(cfg, max_seq=S + 4)(
        params, {"tokens": toks})
    rules = ShardingRules(mesh)
    params_s = shard_tree(rules, params, param_axes(cfg))
    toks_s = shard_tree(rules, toks, ("batch", None))
    lg_s, cache_s = make_prefill_step(cfg, rules, max_seq=S + 4)(
        params_s, {"tokens": toks_s})
    out = {"prefill_max_diff": float(
               (lg_ref.float() - _full(lg_s).float()).abs().max()),
           "logit_scale": float(lg_ref.float().abs().max())}
    if decode:
        dl_ref, _ = make_decode_step(cfg)(
            params, cache_ref, {"tokens": toks[:, -1:]}, S)
        dl_s, _ = make_decode_step(cfg, rules)(
            params_s, cache_s, {"tokens": toks_s[:, -1:]}, S)
        out["decode_max_diff"] = float(
            (dl_ref.float() - _full(dl_s).float()).abs().max())
    return out


def check_jamba_routing(mesh) -> dict:
    """Jamba smoke prefill in its configured bf16 compute with its MoE
    layers: sharded against unsharded as it runs, then again with every
    MoE call's top-k choices pinned to the unsharded run's choices for the
    same rows.  Counts rank 0's routed tokens whose top-k set differs."""
    from repro_torch.nn import moe as moe_mod

    gating = moe_mod._top_k_gating
    calls: list = []  # the unsharded run's (logits, choices) a MoE call
    st = {"mode": "record", "i": 0, "flipped": 0, "routed": 0,
          "dist": 0.0, "margin": float("inf")}

    def hooked(logits, m):
        gates, oh = gating(logits, m)
        if st["mode"] == "record":
            calls.append((logits.detach().clone(), oh.argmax(-1)))
            return gates, oh
        ref_logits, ref_topi = calls[st["i"] % len(calls)]
        st["i"] += 1
        # each local dispatch group is one of the unsharded run's groups
        # (one batch row here): the nearest by its router logits
        d = (logits[:, None] - ref_logits[None]).abs().amax(dim=(2, 3))
        near = d.topk(min(2, d.shape[1]), dim=1, largest=False).values
        dist, match = d.min(dim=1)
        st["dist"] = max(st["dist"], float(dist.max()))
        if near.shape[1] > 1:  # how much nearer the match than the next
            st["margin"] = min(st["margin"], float(
                (near[:, 1] - near[:, 0]).min()))
        want = ref_topi[match]  # (g, s, k)
        if st["mode"] == "compare":
            got = oh.argmax(-1)
            differ = (got.sort(-1).values != want.sort(-1).values).any(-1)
            st["flipped"] += int(differ.sum())
            st["routed"] += differ.numel()
            return gates, oh
        probs = torch.softmax(logits, dim=-1)
        topv = torch.gather(probs, -1, want)
        topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
        gates = torch.zeros_like(probs).scatter(-1, want, topv)
        oh = torch.nn.functional.one_hot(want, logits.shape[-1]).to(
            probs.dtype)
        return gates, oh

    from repro_torch.configs import get_smoke
    from repro_torch.distributed import ShardingRules, shard_tree
    from repro_torch.nn import init_params, param_axes
    from repro_torch.serving import make_prefill_step

    cfg = get_smoke("jamba-v0.1-52b")
    params = init_params(cfg, seed=0, device="cpu")
    S, B = 24, 2
    toks = (torch.arange(B * S, dtype=torch.int32).reshape(B, S) * 7) \
        % cfg.vocab
    rules = ShardingRules(mesh)
    params_s = shard_tree(rules, params, param_axes(cfg))
    toks_s = shard_tree(rules, toks, ("batch", None))
    moe_mod._top_k_gating = hooked
    try:
        lg_ref, _ = make_prefill_step(cfg, max_seq=S + 4)(
            params, {"tokens": toks})
        out = {"moe_calls": len(calls)}
        for mode in ("compare", "pinned"):
            st["mode"], st["i"] = mode, 0
            lg_s, _ = make_prefill_step(cfg, rules, max_seq=S + 4)(
                params_s, {"tokens": toks_s})
            out[f"{mode}_calls"] = st["i"]
            out[f"{mode}_max_diff"] = float(
                (lg_ref.float() - _full(lg_s).float()).abs().max())
            out[f"{mode}_match_max_dist"] = st["dist"]
            st["dist"] = 0.0
    finally:
        moe_mod._top_k_gating = gating
    out["prefill_max_diff"] = out.pop("compare_max_diff")
    return {**out, "logit_scale": float(lg_ref.float().abs().max()),
            "flipped_tokens": st["flipped"], "routed_tokens": st["routed"],
            "match_margin": st["margin"]}


DRIVER_ARGS = ["--arch", "qwen3-4b", "--smoke", "--steps", "3", "--batch",
               "4", "--seq", "16", "--device", "cpu", "--log-every", "100"]


def check_driver() -> dict:
    """``launch.train`` under the running group: a (4, 2) mesh of its
    ranks (``--model-parallel 2``)."""
    from repro_torch.launch import train

    out = train.main(DRIVER_ARGS + ["--model-parallel", "2"])
    return {"driver_losses": out["losses"]}


def main() -> None:
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg",
                            rank=rank, world_size=world)
    try:
        m42, m24 = _mesh((4, 2)), _mesh((2, 4))
        out = {**check_psum(m42), **check_train(m42), **check_driver(),
               "mistral": check_serving(m24, "mistral-nemo-12b", True),
               "rwkv": check_serving(m24, "rwkv6-3b", False),
               "jamba_fp32": check_serving(m24, "jamba-v0.1-52b", False,
                                           compute_dtype="float32"),
               "jamba_dense_bf16": check_serving(m24, "jamba-v0.1-52b",
                                                 False, moe=None),
               "jamba_moe_bf16": check_jamba_routing(m24)}
        if rank == 0:
            with open(os.path.join(d, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
