"""The surrogate fit's train step and validation loss as CUDA graphs.

``models.train.fit_mlp`` keeps its state in buffers that the step updates
in place (the parameters, Adam's moments and step, the step's index into
the epoch's batches) and gathers each batch on the device.  On the card
the step and the validation loss are captured once a fit and replayed;
on the host they run eagerly.  Here, without a card:

* The in-place fit equals the fit written functionally (Adam returning
  new tensors, each batch copied from the host, the best parameters kept
  by reference), bit for bit: parameters, best validation loss, epochs.
* Through the stand-in of ``tests/_graph_stand_in.py`` the step and the
  validation capture (nothing syncs with the host), and the replayed fit
  equals the eager one bit for bit, with dropout (the generator
  registered with the step's graph) and from ``init_params``.
* The best parameters are a copy, not the buffers the next step
  overwrites; a warm start leaves the caller's parameters as they were.

The ``cuda`` cases need the card (skipped here from a fixture): the graph
fit equals the eager fit bit for bit at the paper's shape, with dropout
and from ``init_params``, and launches the kernels the eager fit does.
This file imports no JAX, so on the card it runs on its own::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_fit_graphs.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _graph_stand_in import cuda_device, eager as _eager, stand_in  # noqa: F401
from repro_torch.kernels import ops, platform
from repro_torch.models.mlp import MLPSpec, init_mlp, mlp_forward
from repro_torch.models.train import TrainConfig, _adam_update, _fit, fit_mlp

CPU = torch.device("cpu")
HIDDEN = (16, 16)
SMALL = TrainConfig(max_epochs=12, patience=4, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's host-side work: the suite runs
    in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counts():
    platform.reset_launches()
    yield
    platform.reset_launches()


def _data(n: int, D: int, seed: int):
    rng = np.random.default_rng(seed)
    X = rng.random((n, D)).astype(np.float32)
    y = np.exp(1.0 + np.sin(3.0 * X).sum(1) + 0.05 * rng.standard_normal(n))
    return X, y.astype(np.float32)


def _warm_params(D, hidden, seed=7, device=CPU):
    gen = torch.Generator().manual_seed(seed)
    return [{"w": p["w"].to(device), "b": (p["b"] + 0.01).to(device)}
            for p in init_mlp(gen, MLPSpec(D, hidden, 1), device=None)]


def _functional_fit(X, y, hidden, config, log_target, init_params, dev):
    """The fit written functionally: Adam returns new tensors, each batch
    is copied from the host, the best parameters are kept by reference.
    Returns ``(best flat parameters, best_val, epochs, last flat)``."""
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
        params = init_mlp(torch.Generator().manual_seed(int(config.seed)),
                          spec, device=dev)
    else:
        params = [{k: torch.as_tensor(p[k], device=dev) for k in ("w", "b")}
                  for p in init_params]
    L = len(params)
    flat = [p["w"] for p in params] + [p["b"] for p in params]
    opt = {"m": [torch.zeros_like(p) for p in flat],
           "v": [torch.zeros_like(p) for p in flat],
           "t": torch.zeros((), dtype=torch.float32, device=dev)}
    drop_gen = torch.Generator(device=dev).manual_seed(int(config.seed) + 1)

    def layers(f):
        return [{"w": f[i], "b": f[L + i]} for i in range(L)]

    def predict(f, xb, train):
        if train and config.dropout > 0.0:
            return mlp_forward(layers(f), xb, dropout=config.dropout,
                               generator=drop_gen)
        return ops.mlp_forward(xb, f[:L], f[L:])

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    xv, yv = tensor(Xt[val_idx]), tensor(Yt[val_idx])
    best_val, best, bad, epochs = np.inf, flat, 0, 0
    bs = min(config.batch_size, len(tr_idx))
    for _ in range(config.max_epochs):
        order = rng.permutation(len(tr_idx))
        for s in range(0, len(order), bs):
            idx = tr_idx[order[s: s + bs]]
            if len(idx) < bs:
                idx = np.concatenate([idx, tr_idx[order[: bs - len(idx)]]])
            leaves = [p.detach().requires_grad_() for p in flat]
            loss = torch.mean((predict(leaves, tensor(Xt[idx]), True)
                               - tensor(Yt[idx])) ** 2)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                flat, opt = _adam_update(flat, grads, opt, config.lr,
                                         config.weight_decay)
        with torch.no_grad():
            v = float(torch.mean((predict(flat, xv, False) - yv) ** 2))
        epochs += 1
        if v < best_val - 1e-6:
            best_val, best, bad = v, flat, 0
        else:
            bad += 1
            if bad >= config.patience:
                break
    return best, best_val, epochs, flat


def _flat(model):
    return ([p["w"] for p in model.params] + [p["b"] for p in model.params])


def _same_fit(a, b):
    (ma, va, ea), (mb, vb, eb) = a, b
    assert va == vb and ea == eb
    for x, y in zip(_flat(ma), _flat(mb)):
        assert torch.equal(x.cpu(), y.cpu())


CASES = {"dropout": (0.05, False), "no_dropout": (0.0, False),
         "warm_start": (0.05, True)}


def _case(name, device=CPU, hidden=HIDDEN, n=300, config=SMALL):
    dropout, warm = CASES[name]
    X, y = _data(n, 5, 0)
    cfg = TrainConfig(**{**config.__dict__, "dropout": dropout})
    init = _warm_params(5, hidden, device=device) if warm else None
    return X, y, hidden, cfg, True, init


class TestInPlaceFit:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_in_place_fit_equals_the_functional_fit(self, name):
        X, y, hidden, cfg, log_target, init = _case(name)
        model, best_val, epochs = _fit(X, y, hidden, cfg, log_target, init,
                                       CPU, graph=False)
        best, want_val, want_epochs, _ = _functional_fit(
            X, y, hidden, cfg, log_target, init, CPU)
        assert best_val == want_val and epochs == want_epochs
        for got, want in zip(_flat(model), best):
            assert torch.equal(got, want)
        assert not platform.route_counts()

    def test_best_is_a_copy_not_an_alias(self):
        """A fit that stops early returns the best epoch's parameters, not
        the last step's (which the buffers hold when it stops)."""
        X, y = _data(300, 5, 1)
        cfg = TrainConfig(max_epochs=40, patience=2, batch_size=64, lr=0.05,
                          dropout=0.0)
        model, _, epochs = _fit(X, y, HIDDEN, cfg, True, None, CPU,
                                graph=False)
        best, _, want_epochs, last = _functional_fit(X, y, HIDDEN, cfg, True,
                                                     None, CPU)
        assert epochs == want_epochs < cfg.max_epochs  # it stopped early
        assert all(torch.equal(a, b) for a, b in zip(_flat(model), best))
        assert not all(torch.equal(a, b) for a, b in zip(_flat(model), last))

    def test_warm_start_leaves_the_callers_parameters(self):
        X, y, hidden, cfg, log_target, init = _case("warm_start")
        before = [{k: p[k].clone() for k in p} for p in init]
        fit_mlp(X, y, hidden, cfg, log_target, init_params=init, device=CPU)
        for p, q in zip(init, before):
            assert torch.equal(p["w"], q["w"]) and torch.equal(p["b"], q["b"])


class TestFitGraphs:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_step_and_validation_capture_and_replay_as_eager(
            self, stand_in, name):
        X, y, hidden, cfg, log_target, init = _case(name)
        stand_in.keep = True  # a fit drops its graphs when it returns
        got = _fit(X, y, hidden, cfg, log_target, init, CPU, graph=True)
        want = _fit(X, y, hidden, cfg, log_target, init, CPU, graph=False)
        _same_fit(got, want)
        graphs = [g() for g in stand_in.graphs]
        assert len(graphs) == 2  # the step, the validation loss
        step, val = graphs
        epochs = got[2]
        n_steps = -(-(300 - int(300 * cfg.val_frac)) // cfg.batch_size)
        assert step.replays == epochs * n_steps and val.replays == epochs
        assert step.generators and not val.generators
        assert step.ops > 0 and val.ops > 0
        assert platform.route_counts() == {"fit:eager": 1, "fit:graph": 1}

    def test_fit_mlp_takes_the_graph_route_where_it_captures(self, stand_in):
        X, y, hidden, cfg, log_target, _ = _case("dropout")
        got = fit_mlp(X, y, hidden, cfg, log_target, device=CPU)
        want = _eager(stand_in, lambda: fit_mlp(X, y, hidden, cfg,
                                                log_target, device=CPU))
        for a, b in zip(_flat(got), _flat(want)):
            assert torch.equal(a, b)
        assert platform.route_counts() == {"fit:eager": 1, "fit:graph": 1}

    def test_each_fit_captures_its_own_graphs(self, stand_in):
        X, y, hidden, cfg, log_target, _ = _case("no_dropout")
        for _ in range(2):
            fit_mlp(X, y, hidden, cfg, log_target, device=CPU)
        assert len(stand_in.graphs) == 4
        assert platform.route_counts() == {"fit:eager": 2, "fit:graph": 2}


@pytest.mark.cuda
class TestFitOnCard:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_graph_fit_equals_the_eager_fit(self, cuda_device, name):
        X, y, hidden, cfg, log_target, init = _case(
            name, cuda_device, hidden=(128,) * 4, n=2048,
            config=TrainConfig(max_epochs=30))
        got = _fit(X, y, hidden, cfg, log_target, init, cuda_device,
                   graph=True)
        graph_launches = platform.launch_counts()
        platform.reset_launches()
        want = _fit(X, y, hidden, cfg, log_target, init, cuda_device,
                    graph=False)
        _same_fit(got, want)
        assert graph_launches == platform.launch_counts()
        assert graph_launches.get("mlp_forward", 0) > 0
        assert not platform.plain_on_cuda_counts()

    def test_fit_mlp_on_the_card_replays(self, cuda_device):
        X, y, hidden, cfg, log_target, _ = _case("dropout", cuda_device)
        fit_mlp(X, y, hidden, cfg, log_target, device=cuda_device)
        assert platform.route_counts() == {"fit:eager": 1, "fit:graph": 1}
