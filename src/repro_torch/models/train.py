"""Training loop for DNN surrogates — the decoupled "modeling engine"
(paper §2.3: runs asynchronously in the background; MOO only consumes the
frozen regressors).

Adam + weight decay + early stopping written out, as in the reference.
Paper hyperparameters (§6: lr=0.1, weight decay=0.1, max_iter=100,
patience=20) are kept as named constants; defaults here are mildly saner
for the synthetic traces but the paper's values are a constructor away.

On the card the validation loss and every dropout-free train step run the
fused-forward kernel (``kernels.ops.mlp_forward``; the gradient comes back
through its ``autograd.Function``).  Steps with dropout run the plain
dropout forward (``models.mlp.mlp_forward``): the kernel computes no
dropout.  The split and the minibatch order come from
``np.random.default_rng(config.seed)`` as in the reference, so both
packages see the same rows in the same order; He init and the dropout
masks come from ``torch.Generator``s seeded from ``config.seed``.

The reference jits its train step and validation loss once a fit.  Here
the training rows go to the device once a fit, each epoch's padded batch
order once an epoch, and the parameters, Adam's moments and step and the
step's index into the epoch live in buffers that the step updates in
place.  On the card the step and the validation loss are CUDA graphs
(``kernels.graphs``) captured once a fit, after one warm-up whose effects
are undone, and replayed: the step graph once a step, with the dropout
generator registered with it (each replay draws what the eager step
would), the validation graph once an epoch.  ``platform.ROUTES`` counts
``fit:eager`` (warm-ups) and ``fit:graph`` (fits run by replays).  On the
host the same closures run eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import graphs, ops, platform
from ..kernels.platform import resolve_device
from .mlp import MLPRegressor, MLPSpec, init_mlp, mlp_forward

PAPER_HPARAMS = dict(lr=0.1, weight_decay=0.1, max_epochs=100, patience=20)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, early stopping and regularization of one fit."""

    lr: float = 3e-3
    weight_decay: float = 1e-4
    max_epochs: int = 200
    patience: int = 20
    batch_size: int = 256
    val_frac: float = 0.15
    dropout: float = 0.05
    seed: int = 0


def _adam_update(params, grads, opt, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step with decoupled weight decay (the reference's
    ``_adam_update``); returns new parameter tensors and state."""
    t = opt["t"] + 1.0
    m = [b1 * m_ + (1 - b1) * g for m_, g in zip(opt["m"], grads)]
    v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(opt["v"], grads)]
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    new = []
    for p, m_, v_ in zip(params, m, v):
        mh = m_ / bc1
        vh = v_ / bc2
        new.append(p - lr * (mh / (torch.sqrt(vh) + eps) + wd * p))
    return new, {"m": m, "v": v, "t": t}


def _tensor(a, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _layers(flat: list, n: int) -> list[dict]:
    return [{"w": flat[i], "b": flat[n + i]} for i in range(n)]


def fit_mlp(
    X: np.ndarray,
    y: np.ndarray,
    hidden: tuple = (128, 128, 128, 128),
    config: TrainConfig = TrainConfig(),
    log_target: bool = False,
    init_params: list | None = None,
    device=None,
) -> MLPRegressor:
    """Fit a standardized MLP regressor on encoded configs -> one objective,
    on ``device`` (``None`` means ``cuda``).

    ``log_target=True`` trains on log(y) (latency/cost-style positive
    targets spanning decades) and inverts at prediction time.

    ``init_params`` warm-starts optimization from an existing parameter
    list (a previous snapshot of the same workload, or a neighboring
    workload's model — the online model server's retraining path) instead
    of He-init; layer shapes must match ``hidden``.
    """
    dev = resolve_device(device)
    return _fit(X, y, hidden, config, log_target, init_params, dev,
                graphs.captures(dev))[0]


def _fit(X, y, hidden, config: TrainConfig, log_target: bool, init_params,
         dev: torch.device, graph: bool) -> tuple:
    """:func:`fit_mlp` on ``dev``, its steps and validations replayed as
    CUDA graphs when ``graph`` (else run eagerly: both give the same bits).
    Returns ``(regressor, best validation loss, epochs run)``."""
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32).reshape(-1, 1)
    if log_target:
        y = np.log(np.maximum(y, 1e-12))
    n = len(X)
    rng = np.random.default_rng(config.seed)
    perm = rng.permutation(n)
    n_val = max(1, int(n * config.val_frac))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    x_mean, x_std = X[tr_idx].mean(0), X[tr_idx].std(0) + 1e-9
    y_mean, y_std = y[tr_idx].mean(0), y[tr_idx].std(0) + 1e-9
    Xt = (X - x_mean) / x_std
    Yt = (y - y_mean) / y_std

    spec = MLPSpec(in_dim=X.shape[1], hidden=hidden, out_dim=1,
                   dropout=config.dropout)
    if init_params is None:
        gen = torch.Generator().manual_seed(int(config.seed))
        params = init_mlp(gen, spec, device=dev)
    else:
        dims = spec.layer_dims
        expect = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
        got = [tuple(np.shape(layer["w"])) for layer in init_params]
        if got != expect:
            raise ValueError(
                f"init_params layer shapes {got} do not match the requested "
                f"architecture {expect}")
        params = [{k: _tensor(layer[k], dev) for k in ("w", "b")}
                  for layer in init_params]
    L = len(params)
    # the state, updated in place (never the caller's init_params)
    flat = [p["w"].clone() for p in params] + [p["b"].clone()
                                               for p in params]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    t = torch.zeros((), dtype=torch.float32, device=dev)
    drop_gen = torch.Generator(device=dev).manual_seed(int(config.seed) + 1)

    # the rows on the device once a fit; an epoch's padded batches of row
    # indices once an epoch; the step's row of them, advanced by the step
    Xd, Yd = _tensor(Xt, dev), _tensor(Yt, dev)
    xv, yv = _tensor(Xt[val_idx], dev), _tensor(Yt[val_idx], dev)
    bs = min(config.batch_size, len(tr_idx))
    n_steps = -(-len(tr_idx) // bs)
    batches = torch.zeros((n_steps, bs), dtype=torch.int64, device=dev)
    s = torch.zeros((1,), dtype=torch.int64, device=dev)

    def predict(flat_, xb, train: bool):
        if train and config.dropout > 0.0:
            return mlp_forward(_layers(flat_, L), xb,
                               dropout=config.dropout, generator=drop_gen)
        return ops.mlp_forward(xb, flat_[:L], flat_[L:])

    def train_step():
        rows = batches.index_select(0, s).view(-1)
        xb, yb = Xd.index_select(0, rows), Yd.index_select(0, rows)
        leaves = [p.detach().requires_grad_() for p in flat]
        loss = torch.mean((predict(leaves, xb, True) - yb) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new, opt = _adam_update(flat, grads, {"m": m, "v": v, "t": t},
                                    config.lr, config.weight_decay)
            for dst, src in zip([*flat, *m, *v, t],
                                [*new, *opt["m"], *opt["v"], opt["t"]]):
                dst.copy_(src)
            s.add_(1)

    def val_loss():
        with torch.no_grad():
            return (torch.mean((predict(flat, xv, False) - yv) ** 2),)

    def run_steps():
        for _ in range(n_steps):
            train_step()

    run_val = val_loss
    if graph:
        run_steps, run_val = _fit_graphs(
            train_step, val_loss, n_steps, dev, drop_gen,
            (flat, m, v, t, s))

    best_val, best, bad, epochs = np.inf, [p.clone() for p in flat], 0, 0
    for _epoch in range(config.max_epochs):
        order = rng.permutation(len(tr_idx))
        idx = []
        for s0 in range(0, len(order), bs):
            rows = tr_idx[order[s0: s0 + bs]]
            if len(rows) < bs:  # the reference pads to a static batch shape
                rows = np.concatenate([rows, tr_idx[order[: bs - len(rows)]]])
            idx.append(rows)
        batches.copy_(torch.from_numpy(np.stack(idx).astype(np.int64)))
        s.zero_()
        run_steps()
        val = float(run_val()[0])
        epochs += 1
        if val < best_val - 1e-6:
            # a copy: the next step overwrites the buffers in place
            best_val, best, bad = val, [p.clone() for p in flat], 0
        else:
            bad += 1
            if bad >= config.patience:
                break
    if graph:
        platform.ROUTES["fit:graph"] += 1
    model = MLPRegressor(
        spec=spec,
        params=_layers(best, L),
        x_mean=_tensor(x_mean, dev),
        x_std=_tensor(x_std, dev),
        y_mean=_tensor(y_mean, dev),
        y_std=_tensor(y_std, dev),
        dropout=max(config.dropout, 0.05),
        log_target=log_target,
    )
    return model, best_val, epochs


def _fit_graphs(train_step, val_loss, n_steps: int, dev, drop_gen,
                state) -> tuple:
    """The fit's step and validation loss captured as CUDA graphs on
    ``dev``: one warm-up of each on the side stream (counted as
    ``fit:eager``), whose effects on ``state`` (the parameters, Adam's
    moments and step, the step index) and on ``drop_gen`` are undone, then
    the captures (``drop_gen`` registered with the step's graph).  Returns
    ``(run_steps, run_val)``: an epoch's ``n_steps`` step replays, and one
    validation replay with its static output."""
    flat, m, v, t, s = state
    start = [p.clone() for p in flat]
    gen_state = drop_gen.get_state()
    what = "the surrogate fit's step"
    with graphs.building(dev) as stream:
        graphs.warm_up(stream, lambda: (train_step(), val_loss()))
        platform.ROUTES["fit:eager"] += 1
        drop_gen.set_state(gen_state)
        step_graph = graphs.capture(train_step, stream, dev, what,
                                    generators=(drop_gen,), route="fit")
        val_graph = graphs.capture(val_loss, stream, dev,
                                   "the surrogate fit's validation loss",
                                   route="fit")
    for p, p0 in zip(flat, start):  # after the side stream's work
        p.copy_(p0)
    for buf in (*m, *v, t, s):
        buf.zero_()
    return (lambda: step_graph.replay(n_steps)), val_graph.replay


def regression_report(model, X: np.ndarray, y: np.ndarray) -> dict:
    """Relative-error stats; the paper reports OtterTune model errors of
    10-40% — used by expt4 to characterize the 'inaccurate models' regime."""
    with torch.no_grad():
        pred = model(torch.as_tensor(np.asarray(X), dtype=torch.float32,
                                     device=model.device))
    pred = pred.cpu().numpy()
    y = np.asarray(y).reshape(-1)
    rel = np.abs(pred - y) / np.maximum(np.abs(y), 1e-9)
    return {
        "mape": float(rel.mean()),
        "p50": float(np.median(rel)),
        "p90": float(np.quantile(rel, 0.9)),
        "rmse": float(np.sqrt(np.mean((pred - y) ** 2))),
    }
