"""Quick smoke of the PyTorch port: every arch's reduced config through a
train step, prefill and decode, and its abstract parameters against the
concrete ones.  Runs on the card unless ``--device cpu``; ends with one
JSON line of the kernels' launch counts.

    PYTHONPATH=src python scripts/torch_smoke_archs.py [--device cpu] \
        [--archs qwen3-4b rwkv6-3b]
"""

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.kernels import platform
from repro_torch.nn import (
    abstract_params,
    decode_step,
    init_params,
    prefill,
)
from repro_torch.nn.model import tree_leaves
from repro_torch.training import (
    AdamConfig,
    TrainStepConfig,
    adam_init,
    make_train_step,
)

B, S = 2, 64


def batch_for(cfg, device) -> dict:
    if cfg.embed_input:
        return {"embeds": torch.ones((B, S, cfg.d_model), dtype=torch.bfloat16,
                                     device=device),
                "labels": torch.zeros((B, S), dtype=torch.int32,
                                      device=device)}
    return {"tokens": torch.arange(B * S, dtype=torch.int32, device=device)
            .reshape(B, S) % cfg.vocab}


def smoke(arch: str, device) -> dict:
    """One architecture's smoke config through the checks; raises on the
    first that fails."""
    cfg = get_smoke(arch)
    params = init_params(cfg, seed=0, device=device)
    n = sum(p.numel() for p in tree_leaves(params))
    step = make_train_step(cfg, TrainStepConfig(adam=AdamConfig()))
    _, _, m = step(params, adam_init(params, AdamConfig()),
                   batch_for(cfg, device))
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise ValueError(f"loss={loss}")
    with torch.no_grad():  # serving
        logits, cache = prefill(params, cfg, batch_for(cfg, device),
                                max_seq=S + 8)
        if tuple(logits.shape) != (B, cfg.vocab):
            raise ValueError(f"prefill logits {tuple(logits.shape)}")
        db = ({"embeds": torch.ones((B, 1, cfg.d_model), dtype=torch.bfloat16,
                                    device=device)}
              if cfg.embed_input else
              {"tokens": torch.zeros((B, 1), dtype=torch.int32,
                                     device=device)})
        lg2, cache = decode_step(params, cfg, cache, db, S)
    if tuple(lg2.shape) != (B, cfg.vocab):
        raise ValueError(f"decode logits {tuple(lg2.shape)}")
    if not torch.isfinite(lg2.float()).all():
        raise ValueError("non-finite decode logits")
    # abstract params match concrete shapes and dtypes
    same = all(c.shape == a.shape and c.dtype == a.dtype for c, a in zip(
        tree_leaves(params), tree_leaves(abstract_params(cfg))))
    if not same or len(list(tree_leaves(params))) != len(
            list(tree_leaves(abstract_params(cfg)))):
        raise ValueError("abstract/concrete mismatch")
    return {"params_m": n / 1e6, "loss": loss}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--archs", nargs="*", default=list(ARCH_IDS))
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    fails, done = [], {}
    for a in args.archs:
        try:
            done[a] = smoke(a, device)
            print(f"OK   {a:20s} params={done[a]['params_m']:8.3f}M "
                  f"loss={done[a]['loss']:.3f}")
        except Exception as e:  # noqa: BLE001 (report every arch)
            import traceback

            traceback.print_exc()
            print(f"FAIL {a}: {type(e).__name__}: {e}")
            fails.append(a)
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    if fails:
        sys.exit(f"failures: {fails}")
    print("all architectures smoke-pass")
    print(json.dumps(counts), flush=True)
    return {"archs": done, **counts}


if __name__ == "__main__":
    main()
