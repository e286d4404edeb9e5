"""One rank of the port's multi-rank CPU checks (``tests/test_torch_distributed.py``
and, in the ``resume`` mode, ``tests/test_torch_dist_resume.py``).

Run as ``python tests/torch_dist_ranks.py RANK WORLD DIR [MODE]``: every
rank joins a gloo group through ``file://DIR/pg`` and runs the same checks
on a ``(4, 2)`` and a ``(2, 4)`` ``("data", "model")`` mesh; rank 0 writes
the readings to ``DIR/result.json``.  The default mode runs the checks
below; ``resume`` runs ``check_resume``'s (sharded checkpoints, the
sharded driver's save and resume, ``ServeEngine(rules=)`` and
``TokenLoader(sharding=)``).

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
* the sharded MoE (``MOE_CASES``, on the ``(2, 4)`` mesh) from weights the
  test process wrote as numpy (``DIR/<case>.pkl``, the reference's
  tree): fp32 prefill and decode sharded against unsharded, the sharded
  logits saved as ``DIR/<case>_{prefill,decode}.npy`` for the test
  process to hold to the reference's, the local shards of the first MoE
  layer and the collectives of one sharded MoE call; and qwen2-moe smoke
  train steps on both routes.
"""

import dataclasses
import json
import os
import pickle
import shutil
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


def _named_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of a parameter tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _named_leaves(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _grad_rel(cfg, params, batch, params_s, batch_s, rules) -> dict:
    """Each floating parameter's sharded gradient (``grads_of``, the whole
    tensor) against the unsharded one: the largest difference relative
    to the largest unsharded entry, by path."""
    from repro_torch.distributed import sharded_region
    from repro_torch.training.train_step import grads_of

    g_ref, _ = grads_of(params, cfg, batch)
    with sharded_region(rules):
        g_s, _ = grads_of(params_s, cfg, batch_s, rules=rules)
    return {path: float((_full(b) - a).abs().max()
                        / a.abs().max().clamp_min(1e-30))
            for (path, a), (_, b) in zip(_named_leaves(g_ref),
                                         _named_leaves(g_s))
            if a.is_floating_point()}


def check_train(mesh, arch: str = "qwen3-4b", compute: str | None = None,
                seq: int = 32, rules_over: dict | None = None,
                grads: bool = False) -> dict:
    """The train step sharded against unsharded; with ``grads``, also
    every parameter's gradient (``_grad_rel``)."""
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

    rules = ShardingRules(mesh).with_overrides(**(rules_over or {}))
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
    out = {"loss_plain": float(m_ref["loss"]),
           "loss_sharded": float(m_s["loss"]),
           "grad_norm_plain": float(m_ref["grad_norm"]),
           "grad_norm_sharded": float(m_s["grad_norm"]),
           "param_delta_max": delta, "placements_kept": kept}
    if grads:
        out["grad_rel"] = _grad_rel(cfg, params, batch, params_s, batch_s,
                                    rules)
    return out


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


# the sharded MoE's cases: the smoke config, its MoE config's changes, the
# dispatch, the rules' overrides and the prompt length.  "drops" is
# TestMoECapacityParity's config (4 experts, groups of 16, capacity 8 <
# the loads), on the scatter/gather dispatch
TP_RULES = {"expert": (), "expert_ff": ("model",)}
_DROPS = {"num_experts": 4, "group_size": 16, "capacity_factor": 1.0}
MOE_CASES = {
    "jamba_ep": ("jamba-v0.1-52b", {}, "einsum", {}, 24),
    "qwen_ep": ("qwen2-moe-a2.7b", {}, "einsum", {}, 24),
    "qwen_tp": ("qwen2-moe-a2.7b", {}, "einsum", TP_RULES, 24),
    "drops_ep": ("qwen2-moe-a2.7b", _DROPS, "gather", {}, 32),
    "drops_tp": ("qwen2-moe-a2.7b", _DROPS, "gather", TP_RULES, 32),
}
MOE_B = 2


def moe_case_cfg(configs, case: str):
    """A case's fp32 config from ``configs`` (either package's)."""
    arch, moe_over, impl, _, _ = MOE_CASES[case]
    cfg = configs.get_smoke(arch)
    return cfg.replace(compute_dtype="float32", moe_impl=impl,
                       moe=dataclasses.replace(cfg.moe, **moe_over))


def moe_case_tokens(case: str, vocab: int):
    """A case's prompt (MOE_B, S) as int32 numpy, and its decode token."""
    import numpy as np

    S = MOE_CASES[case][4]
    toks = (np.arange(MOE_B * S, dtype=np.int32).reshape(MOE_B, S) * 7
            + 3) % vocab
    return toks, toks[:, -1:]


def _first_moe(params):
    for unit in params["blocks"]:
        for layer in unit.values():
            if "moe" in layer:
                return layer["moe"]
    raise ValueError("no MoE layer")


def check_moe(mesh, case: str, d: str) -> dict:
    """One ``MOE_CASES`` case: the reference's weights from ``DIR``, fp32
    prefill and decode sharded against unsharded; the first MoE layer's
    local shards; the collectives of one sharded MoE call."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.distributed import (
        ShardingRules,
        collective_log,
        constrain,
        shard_tree,
        sharded_region,
    )
    from repro_torch.nn import param_axes
    from repro_torch.nn.convert import params_from_numpy
    from repro_torch.nn.model import cast_params
    from repro_torch.nn.moe import moe
    from repro_torch.serving import make_decode_step, make_prefill_step

    cfg = moe_case_cfg(configs, case)
    with open(os.path.join(d, f"{case}.pkl"), "rb") as f:
        params = params_from_numpy(pickle.load(f), "cpu")
    toks, last = map(torch.tensor, moe_case_tokens(case, cfg.vocab))
    S = toks.shape[1]
    rules = ShardingRules(mesh).with_overrides(**MOE_CASES[case][3])
    params_s = shard_tree(rules, params, param_axes(cfg))
    toks_s = shard_tree(rules, toks, ("batch", None))
    last_s = shard_tree(rules, last, ("batch", None))
    out = {}
    lg, cache = make_prefill_step(cfg, max_seq=S + 4)(params, {"tokens": toks})
    lg_s, cache_s = make_prefill_step(cfg, rules, max_seq=S + 4)(
        params_s, {"tokens": toks_s})
    dl, cache_d = make_decode_step(cfg)(params, cache, {"tokens": last}, S)
    dl_s, cache_ds = make_decode_step(cfg, rules)(params_s, cache_s,
                                                  {"tokens": last_s}, S)
    loads = [(layer["moe_counts"], _full(layer_s["moe_counts"]))
             for c, c_s in ((cache, cache_s), (cache_d, cache_ds))
             for unit, unit_s in zip(c, c_s)
             for layer, layer_s in zip(unit.values(), unit_s.values())
             if "moe_counts" in layer]
    out["counts_equal"] = all(torch.equal(a, b) for a, b in loads)
    out["max_load"] = max(int(a.max()) for a, _ in loads)  # the prefill's
    for name, want, got in (("prefill", lg, lg_s), ("decode", dl, dl_s)):
        got = _full(got)
        out[f"{name}_rel"] = float((got - want).abs().max()
                                   / want.abs().max())
        if dist.get_rank() == 0:
            np.save(os.path.join(d, f"{case}_{name}.npy"), got.numpy())
    w = _first_moe(params_s)
    out["local_w1"] = list(w["w1"].to_local().shape)
    out["global_w1"] = list(w["w1"].shape)
    out["local_w2"] = list(w["w2"].to_local().shape)
    # one sharded MoE call, its output laid out as the residual stream
    x = torch.randn((MOE_B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    x_s = shard_tree(rules, x, ("batch", None, "embed"))
    with sharded_region(rules):
        p_l = cast_params(w, torch.float32, rules)
        shapes = {tuple(t.to_local().shape) for t in p_l.values()}
        log = collective_log()
        with log:
            y = constrain(moe(p_l, cfg, cfg.moe, x_s, rules), rules,
                          "batch", None, "embed")
    out["call_collectives"] = sorted({k for k, _, _ in log.records})
    out["call_weight_gathers"] = sum(
        1 for k, shp, _ in log.records
        if k == "all-gather" and shp in shapes)
    out["call_rel"] = float((_full(y) - moe(
        _first_moe(params), cfg, cfg.moe, x)).abs().max() / _full(y).abs()
        .max())
    return out


DRIVER_ARGS = ["--arch", "qwen3-4b", "--smoke", "--steps", "3", "--batch",
               "4", "--seq", "16", "--device", "cpu", "--log-every", "100"]


def check_driver() -> dict:
    """``launch.train`` under the running group: a (4, 2) mesh of its
    ranks (``--model-parallel 2``)."""
    from repro_torch.launch import train

    out = train.main(DRIVER_ARGS + ["--model-parallel", "2"])
    return {"driver_losses": out["losses"]}


# the sharded driver's save and resume (``check_resume``): a checkpoint
# at RESUME_STEPS[0], a resume to RESUME_STEPS[1]
RESUME_ARGS = ["--arch", "qwen3-4b", "--smoke", "--batch", "4", "--seq",
               "16", "--device", "cpu", "--log-every", "100",
               "--model-parallel", "2", "--ckpt-every", "2"]
RESUME_STEPS = (2, 4)
# ServeEngine(rules=) against the plain engine: 4 requests on 2 slots
ENGINE_ARCHS = ("qwen3-4b", "jamba-v0.1-52b")
ENGINE_NEW = 6


def _placements(tree) -> list:
    """Each leaf's placements (None for a plain tensor), in
    ``tree_leaves`` order."""
    from repro_torch.nn.model import tree_leaves

    return [list(t.placements) if hasattr(t, "placements") else None
            for t in tree_leaves(tree)]


def _same(got, want) -> dict:
    """``got`` and ``want`` (trees of DTensors or tensors) leaf for leaf:
    whether every gathered leaf is equal bit for bit, in the same dtype."""
    from repro_torch.nn.model import tree_leaves

    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    return {"leaves": len(pairs),
            "bitwise": all(a.dtype == b.dtype and torch.equal(
                _full(a), _full(b)) for a, b in pairs)}


def _fresh_state(cfg, rules, adam, seed: int = 7) -> dict:
    """Another init and zero Adam state, sharded by ``rules`` (None: one
    device): a restore target whose values differ from the saved ones."""
    from repro_torch.distributed import shard_tree
    from repro_torch.nn import init_params, param_axes
    from repro_torch.training import adam_init

    params = init_params(cfg, seed=seed, device="cpu")
    if rules is not None:
        params = shard_tree(rules, params, param_axes(cfg))
    return {"params": params, "opt": adam_init(params, adam)}


def _state_placements_match(state, rules, cfg) -> bool:
    """The parameters' and both moments' placements equal a fresh
    ``shard_tree``'s by ``param_axes``; the step count a plain tensor."""
    from repro_torch.distributed import shard_tree
    from repro_torch.nn import init_params, param_axes

    want = _placements(shard_tree(rules, init_params(
        cfg, seed=0, device="cpu"), param_axes(cfg)))
    return _placements(state) == want * 3 + [None]


def check_resume(m42, m24, d: str) -> dict:
    """Sharded checkpoints and the sharded serving and loading surface on
    the ``(4, 2)`` mesh ``m42`` and the ``(2, 4)`` mesh ``m24``."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.data.lm_data import MarkovCorpus, TokenLoader
    from repro_torch.distributed import (
        ShardingRules,
        named_sharding,
        shard_tree,
    )
    from repro_torch.launch import train
    from repro_torch.nn import init_params, param_axes
    from repro_torch.nn.convert import stack_blocks
    from repro_torch.runtime import CheckpointError, CheckpointManager
    from repro_torch.runtime.checkpoint import _key, _leaves
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.training import (
        AdamConfig,
        TrainStepConfig,
        adam_init,
        make_train_step,
    )

    out = {}
    r42, r24 = ShardingRules(m42), ShardingRules(m24)
    cfg = get_smoke("qwen3-4b")
    ckpt = os.path.join(d, "ckpt")
    args = RESUME_ARGS + ["--ckpt", ckpt]

    # the sharded driver: a checkpoint at step k, then a resume to n
    k, n = RESUME_STEPS
    r1 = train.main(args + ["--steps", str(k)])
    saved = r1["state"]
    out["first_losses"] = r1["losses"]
    out["saved_placements_match"] = _state_placements_match(saved, r42, cfg)
    full = {"params": _full_tree(saved["params"]),
            "opt": {"mu": _full_tree(saved["opt"]["mu"]),
                    "nu": _full_tree(saved["opt"]["nu"]),
                    "count": saved["opt"]["count"]}}
    if dist.get_rank() == 0:  # the saved state in the reference's layout,
        # and the step-k checkpoint kept apart for the test process
        flat = {_key(p): t.numpy() for p, t in _leaves(
            train._state_layout(full, stack_blocks))}
        with open(os.path.join(d, "saved.pkl"), "wb") as f:
            pickle.dump(flat, f)
        shutil.copytree(ckpt, os.path.join(d, "ckpt_k"))
    mgr = CheckpointManager(ckpt)
    for name, rules in (("same_mesh", r42), ("other_mesh", r24)):
        like = _fresh_state(cfg, rules, AdamConfig())
        got, manifest = train.restore_train_state(mgr, like)
        out[name] = {"step": manifest["step"], **_same(got, saved),
                     "placements_match": _state_placements_match(
                         got, rules, cfg),
                     "placements_kept": _placements(got) == _placements(
                         like)}
    r2 = train.main(args + ["--steps", str(n)])
    out["resumed_losses"] = r2["losses"]
    out["resumed_count"] = int(r2["state"]["opt"]["count"])

    # bf16 moments, saved through the manager and restored bit for bit
    adam = AdamConfig(lr=1e-2, state_dtype="bfloat16")
    params = shard_tree(r42, init_params(cfg, seed=3, device="cpu"),
                        param_axes(cfg))
    toks = torch.arange(4 * 16, dtype=torch.int32).reshape(4, 16) % cfg.vocab
    step = make_train_step(cfg, TrainStepConfig(adam=adam), r42,
                           param_axes=param_axes(cfg))
    p1, o1, _ = step(params, adam_init(params, adam),
                     {"tokens": shard_tree(r42, toks, ("batch", None))})
    state = {"params": p1, "opt": o1}
    bf = CheckpointManager(os.path.join(d, "bf16"))
    bf.save_async(1, train.checkpoint_tree(state))
    bf.wait()
    got, _ = train.restore_train_state(bf, _fresh_state(cfg, r24, adam))
    out["bf16"] = {**_same(got, state),
                   "moment_dtype": str(got["opt"]["mu"]["embed"]["tok"]
                                       .dtype),
                   "placements_match": _state_placements_match(got, r24,
                                                               cfg)}

    # a write that fails on rank 0 raises on every rank
    bad = os.path.join(d, "not_a_dir")
    if dist.get_rank() == 0:
        with open(bad, "w") as f:
            f.write("a file where the checkpoint directory should be")
    dist.barrier()
    failing = CheckpointManager(bad)
    failing.save_async(1, train.checkpoint_tree(state))
    try:
        failing.wait()
        raised = None
    except CheckpointError as e:
        raised = e.steps
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, raised)
    out["failed_write_raised"] = every

    # ServeEngine(rules=) against the plain engine, fp32 compute
    out["engine"] = {}
    for arch in ENGINE_ARCHS:
        ecfg = get_smoke(arch).replace(compute_dtype="float32")
        eparams = init_params(ecfg, seed=0, device="cpu")
        toks = {}
        for name, rules in (("plain", None), ("rules", r42)):
            p = eparams if rules is None else shard_tree(
                rules, eparams, param_axes(ecfg))
            eng = ServeEngine(p, ecfg, batch=2, max_seq=40, rules=rules,
                              device="cpu")
            rng = np.random.default_rng(0)
            reqs = [Request(rid=i, prompt=rng.integers(
                0, ecfg.vocab, 8 + 4 * i).astype(np.int32),
                max_new=ENGINE_NEW) for i in range(4)]
            toks[name] = [r.out for r in eng.run(reqs)]
        out["engine"][arch] = toks

    # TokenLoader(sharding=): a DTensor on the batch axes, the same draws
    corpus = MarkovCorpus(cfg.vocab, seed=0)
    sh = named_sharding(r42, ("batch", None), (8, 16))
    plain = TokenLoader(corpus, 8, 16, device="cpu", seed=1)
    placed = TokenLoader(corpus, 8, 16, sharding=sh, seed=1)
    batches = [(next(plain)["tokens"], next(placed)["tokens"])
               for _ in range(3)]
    plain.close()
    placed.close()
    b = batches[0][1]
    out["loader"] = {
        "placements": [str(p) for p in b.placements],
        "local_shape": list(b.to_local().shape),
        "equal": all(torch.equal(a, _full(c)) for a, c in batches)}
    return out


def _full_tree(tree):
    from repro_torch.exec import tree_map

    return tree_map(_full, tree)


def main() -> None:
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "all"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg",
                            rank=rank, world_size=world)
    try:
        m42, m24 = _mesh((4, 2)), _mesh((2, 4))
        out = check_resume(m42, m24, d) if mode == "resume" else {**check_psum(m42), **check_train(m42), **check_driver(),
               "mistral": check_serving(m24, "mistral-nemo-12b", True),
               "rwkv": check_serving(m24, "rwkv6-3b", False),
               "jamba_fp32": check_serving(m24, "jamba-v0.1-52b", False,
                                           compute_dtype="float32"),
               "jamba_dense_bf16": check_serving(m24, "jamba-v0.1-52b",
                                                 False, moe=None),
               "jamba_moe_bf16": check_jamba_routing(m24),
               "moe": {c: check_moe(m24, c, d) for c in MOE_CASES},
               "moe_train": {
                   route: check_train(m24, "qwen2-moe-a2.7b", "float32",
                                      rules_over=over, grads=True)
                   for route, over in (("ep", {}), ("tp", TP_RULES))}}
        if rank == 0:
            with open(os.path.join(d, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
