"""Mirrors of two reference test classes on the port, on the CPU.

* ``tests/test_frontier_store.py::TestIncrementalEqualsBatch`` (7 tests,
  the reference's parametrization kept): the port's ``FrontierStore`` on
  ``device="cpu"``, with and without ``use_kernel`` (on the host the
  kernel path takes the dominance kernel's plain version through the
  store's one-upload pass), against the reference's batch Pareto filter.
* ``tests/test_alloc.py::TestGainTelemetry`` (3 tests): the port's gain
  log, ``hv`` and the persist codec's gain fields
  (``core/progressive_frontier.py``) through a ``MOOService`` on the host.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pareto_mask
from repro_torch.core import MOGDConfig
from repro_torch.core.frontier_store import FrontierStore
from repro_torch.core.progressive_frontier import (
    export_pf_state,
    frontier_hypervolume,
    import_pf_state,
)
from repro_torch.core.synthetic import zdt1_task
from repro_torch.service import MOOService

CPU = "cpu"
FAST = MOGDConfig(steps=40, multistart=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_reference(stream):
    """Seed-finalize semantics: dedupe at 1e-9, then the reference's full
    Pareto filter."""
    allF = np.concatenate([f for f, _ in stream])
    allX = np.concatenate([x for _, x in stream])
    _, uniq = np.unique(np.round(allF, 9), axis=0, return_index=True)
    F, X = allF[np.sort(uniq)], allX[np.sort(uniq)]
    mask = np.asarray(pareto_mask(jnp.asarray(F)))
    return F[mask], X[mask]


def _as_set(F):
    return {tuple(np.round(row, 9)) for row in F}


def _offer(F, use_kernel: bool):
    """``F`` as a case offers it: the kernel path stores its offers at
    fp32 resolution (``FrontierStore.add``), so its cases offer fp32-exact
    values, as the reference's own kernel-path case does; the batch
    filter then sees what the store saw."""
    return np.float64(np.float32(F)) if use_kernel else F


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
class TestIncrementalEqualsBatch:
    @pytest.mark.parametrize("k,seed", [(2, 0), (2, 1), (3, 2), (4, 3)])
    def test_random_streams(self, use_kernel, k, seed):
        rng = np.random.default_rng(seed)
        store = FrontierStore(k=k, dim=3, capacity=64, use_kernel=use_kernel,
                              device=CPU)
        stream = []
        for _ in range(40):
            b = int(rng.integers(1, 10))
            F = _offer(rng.uniform(0, 1, (b, k)), use_kernel)
            X = rng.uniform(0, 1, (b, 3))
            stream.append((F, X))
            store.add(F, X)
        F_ref, X_ref = _batch_reference(stream)
        F_got, X_got = store.frontier()
        assert _as_set(F_got) == _as_set(F_ref)
        # X rows stay aligned with their F rows
        lookup = {tuple(np.round(f, 9)): tuple(x)
                  for f, x in zip(F_ref, X_ref)}
        for f, x in zip(F_got, X_got):
            assert lookup[tuple(np.round(f, 9))] == pytest.approx(tuple(x))

    def test_duplicates_collapse(self, use_kernel):
        store = FrontierStore(k=2, dim=1, use_kernel=use_kernel, device=CPU)
        p = np.array([[0.3, 0.7]])
        for _ in range(5):
            store.add(p, np.array([[0.0]]))
        assert store.n_points == 1
        assert store.total_accepted == 1

    def test_dominating_point_retires_many(self, use_kernel):
        store = FrontierStore(k=2, dim=1, use_kernel=use_kernel, device=CPU)
        F = np.array([[0.1, 0.9], [0.5, 0.5], [0.9, 0.1]])
        store.add(F, np.zeros((3, 1)))
        assert store.n_points == 3
        store.add(np.array([[0.05, 0.05]]), np.zeros((1, 1)))
        F_live, _ = store.frontier()
        assert store.n_points == 1
        np.testing.assert_allclose(F_live, [[0.05, 0.05]])

    def test_grow_on_demand_preserves_frontier(self, use_kernel):
        rng = np.random.default_rng(9)
        store = FrontierStore(k=2, dim=2, capacity=64, use_kernel=use_kernel,
                              device=CPU)
        stream = []
        # anti-correlated objectives -> most points survive -> forces growth
        for _ in range(30):
            a = rng.uniform(0, 1, (8, 1))
            F = _offer(np.concatenate(
                [a, 1.0 - a + rng.uniform(0, 1e-3, (8, 1))], 1), use_kernel)
            X = rng.uniform(0, 1, (8, 2))
            stream.append((F, X))
            store.add(F, X)
        assert store.capacity > 64  # grew
        F_ref, _ = _batch_reference(stream)
        F_got, _ = store.frontier()
        assert _as_set(F_got) == _as_set(F_ref)

    def test_kernel_path_matches_jnp_path(self, use_kernel):
        """The store of this case's path against the other path's."""
        rng = np.random.default_rng(4)
        s1 = FrontierStore(k=3, dim=2, use_kernel=use_kernel, device=CPU)
        s2 = FrontierStore(k=3, dim=2, use_kernel=not use_kernel,
                           device=CPU)
        for _ in range(10):
            # fp32-exact values (multiples of 2^-10) so both paths see
            # identical inputs despite the kernel path's fp32 cast
            F = rng.integers(0, 1024, (6, 3)) / 1024.0
            X = rng.uniform(0, 1, (6, 2))
            s1.add(F, X)
            s2.add(F, X)
        f1, _ = s1.frontier()
        f2, _ = s2.frontier()
        assert _as_set(f1) == _as_set(f2)

    def test_nonfinite_rows_rejected(self, use_kernel):
        store = FrontierStore(k=2, dim=1, use_kernel=use_kernel, device=CPU)
        store.add(np.array([[np.inf, 0.1], [0.2, 0.2]]), np.zeros((2, 1)))
        assert store.n_points == 1

    def test_key_set_stays_bounded(self, use_kernel):
        """Dedup keys track live rows only — rejected and retired offers
        must not accumulate (long-lived service sessions)."""
        rng = np.random.default_rng(11)
        store = FrontierStore(k=2, dim=1, use_kernel=use_kernel, device=CPU)
        for _ in range(50):
            F = rng.uniform(0.2, 1.0, (8, 2))
            store.add(F, np.zeros((8, 1)))
        assert len(store._keys) == store.n_points
        # a dominating point retires everything; keys shrink with it
        store.add(np.array([[0.0, 0.0]]), np.zeros((1, 1)))
        assert store.n_points == 1 and len(store._keys) == 1
        # re-offering a retired point is still rejected (transitivity)
        F_old = rng.uniform(0.2, 1.0, (4, 2))
        store.add(F_old, np.zeros((4, 1)))
        assert store.n_points == 1


def _stepped_session(rounds: int):
    svc = MOOService(mogd=FAST, grid_l=2, device=CPU)
    sid = svc.create_session(zdt1_task(device=CPU), batch_rects=2)
    for _ in range(rounds):
        svc.step_sessions([sid], origin=None)
    return svc._sessions[sid].state


class TestGainTelemetry:
    def test_gain_log_monotone_probes_and_hv(self):
        st = _stepped_session(3)
        assert len(st.gain_log) >= 3
        probes = [row[0] for row in st.gain_log]
        assert probes == sorted(probes)
        assert st.hv == pytest.approx(frontier_hypervolume(st))
        assert 0.0 <= st.hv <= 1.0

    def test_codec_roundtrips_gain_fields(self):
        st = _stepped_session(1)
        arrays, meta = export_pf_state(st)
        assert arrays["gain_log"].shape == (len(st.gain_log), 4)
        back = import_pf_state(arrays, meta, device=CPU)
        assert back.hv == pytest.approx(st.hv)
        assert [tuple(r) for r in back.gain_log] == [
            tuple(r) for r in st.gain_log]

    def test_codec_tolerates_legacy_entries(self):
        """Vault entries written before the gain fields existed have
        none: hv is recomputed from the restored frontier, the log
        resumes empty."""
        st = _stepped_session(1)
        arrays, meta = export_pf_state(st)
        del arrays["gain_log"]
        meta = {k: v for k, v in meta.items() if k != "hv"}
        back = import_pf_state(arrays, meta, device=CPU)
        assert back.gain_log == []
        assert back.hv == pytest.approx(frontier_hypervolume(back))
