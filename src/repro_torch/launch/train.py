"""End-to-end training driver.

    python -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 50 \
        --batch 8 --seq 128 --ckpt /tmp/ckpt

Wires together: config -> seeded ``init_params`` on the device -> Adam ->
the train step (the mixers' kernels on the card) -> the prefetching token
loader -> async checkpointing -> straggler telemetry.  Resumes from the
latest checkpoint if one exists.  Checkpoints hold ``{"params", "opt"}``
in the reference's layout (block leaves stacked over units), so either
package resumes from the other's.  Runs on the card unless ``--device
cpu``.

Under a running process group (``torchrun``), the parameters, the Adam
moments and each batch are sharded over a ``(data, model)`` mesh of its
ranks (``--model-parallel`` of them on the model axis) and the step runs
with the sharding rules; every rank draws the same batch and keeps its
shard.  A sharded run checkpoints as one: each leaf is gathered whole and
rank 0 writes it, and a resume restores the parameters and both moments
into their shardings (the step count replicated), on a mesh of any shape.
``--model-parallel`` above 1 without a group raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..data.lm_data import MarkovCorpus, TokenLoader
from ..distributed import ShardingRules, named_sharding, shard_tree
from ..kernels.platform import resolve_device
from ..nn import init_params, param_axes
from ..nn.convert import (
    stack_blocks,
    stacked_like,
    stacked_shardings,
    unstack_blocks,
)
from ..runtime import CheckpointManager, StragglerMonitor
from ..training import AdamConfig, TrainStepConfig, adam_init, make_train_step


def _state_layout(state: dict, fn) -> dict:
    """``fn`` (a block-layout conversion) applied to the parameters and
    both Adam moments of a ``{"params", "opt"}`` state."""
    opt = state["opt"]
    return {"params": fn(state["params"]),
            "opt": {"mu": fn(opt["mu"]), "nu": fn(opt["nu"]),
                    "count": opt["count"]}}


def checkpoint_tree(state: dict) -> dict:
    """A train state as it is written: in the reference's layout (block
    leaves stacked over units, on the state's device and, for DTensors, in
    their shardings; ``CheckpointManager.save_async`` gathers and copies
    it to the host)."""
    with torch.no_grad():
        return _state_layout(state, stack_blocks)


def restore_train_state(mgr: CheckpointManager, like: dict):
    """The newest checkpoint of ``mgr`` as a ``{"params", "opt"}`` state
    with ``like``'s structure, each leaf on the device and in the dtype of
    ``like``'s, and a DTensor leaf in its mesh and placements.  Returns
    (state, manifest); raises ``FileNotFoundError`` when there is none."""
    shardings = _state_layout(like, stacked_shardings)
    shardings["opt"]["count"] = None  # placed as ``like``'s count is
    stacked, manifest = mgr.restore_latest(
        _state_layout(like, stacked_like), shardings=shardings)
    return _state_layout(stacked, unstack_blocks), manifest


def _rules(args):
    """The sharding rules over the running process group's ranks, or None
    without one (one device)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if args.model_parallel > 1:
            raise ValueError(
                f"--model-parallel {args.model_parallel} needs a running "
                f"process group (torchrun) of a multiple of that many ranks")
        return None
    from .mesh import make_host_mesh

    return ShardingRules(make_host_mesh(model=args.model_parallel))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.embed_input:
        raise SystemExit(f"{cfg.name}: stub-frontend arch; use serve driver")
    rules = _rules(args)
    dev = resolve_device(args.device)

    params = init_params(cfg, seed=args.seed, device=dev)
    axes = param_axes(cfg)
    if rules is not None:
        params = shard_tree(rules, params, axes)
    adam = AdamConfig(lr=args.lr)
    opt = adam_init(params, adam)
    step_fn = make_train_step(
        cfg, TrainStepConfig(adam=adam, microbatches=args.microbatches),
        rules, param_axes=None if rules is None else axes)

    corpus = MarkovCorpus(cfg.vocab, seed=args.seed)
    sharding = None if rules is None else named_sharding(
        rules, ("batch", None), (args.batch, args.seq))
    loader = TokenLoader(corpus, args.batch, args.seq, sharding=sharding,
                         device=dev, seed=args.seed + 1)

    start = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr is not None:
        try:
            state, manifest = restore_train_state(
                mgr, {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            start = manifest["step"]
            print(f"[train] resumed from step {start}")
        except FileNotFoundError:
            pass

    # one host without a group, as the reference counts its processes
    n_hosts = 1 if rules is None else torch.distributed.get_world_size()
    monitor = StragglerMonitor(n_hosts=n_hosts)
    losses = []
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = next(loader)
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        monitor.observe(np.array([dt] * n_hosts))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:7.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:7.1f}ms")
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, checkpoint_tree(
                {"params": params, "opt": opt}), extra={"loss": loss})
    if mgr is not None:
        mgr.wait()
    loader.close()
    wall = time.perf_counter() - t_start
    if losses:
        print(f"[train] done: {args.steps - start} steps in {wall:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses, "wall_s": wall,
            "slowdown": monitor.slowdown(),
            "state": {"params": params, "opt": opt}}


if __name__ == "__main__":
    main()
