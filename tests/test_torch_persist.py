"""The port's durable frontier plane and checkpoints against the reference.

The classes mirror ``tests/test_persist.py`` (``TestStore``,
``TestPFStateCodec``, ``TestVault``, ``TestServiceRestart``,
``TestRegistryRehydration``) and ``tests/test_runtime.py::TestCheckpoint``
on the port, on the host (``device="cpu"``), with the reference's
assertions: the content-addressed store's atomic commit and integrity
checks, PF state round trips, the vault's lifecycle (write-behind,
tombstones, warm restart), the service's snapshot -> cold restart -> warm
start, registry rehydration with bit-exact task signatures, and the
checkpointer's atomicity, retention and failure reporting.

``TestCrossPackage`` holds the on-disk formats to the reference's, both
ways, on the same directories:

* a PF state the reference writes (``mlp_surrogate_task(seed=0)``, its
  weights carried across with ``models.convert``) restores in the port to
  the same frontier, Pareto mask, row history and rectangle queue, exactly
  — and through a port ``MOOService`` with no dispatch; the converse too;
* a workload record the reference's registry persists (MLP and GP)
  rehydrates in the port with the same workload signature, snapshot
  lineage and model identity (``model_id``), and predicts as the
  reference's model does (1e-5); the converse too.  The task-spec
  signature itself differs across the packages by design: the port's
  hashes the device;
* fp32 and int checkpoints load across both ways, with the same leaf keys
  and tree notation in the manifest; a bf16 checkpoint of either package
  loads in the port bit for bit, while the reference cannot load a bf16
  leaf at all (numpy cannot cast its raw ``V2`` bytes back).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.synthetic as JS
import repro.persist as JP
import repro.runtime as JR
import repro_torch.core as P
from repro.core.progressive_frontier import export_pf_state as j_export
from repro.modelserver import DriftConfig as JDriftConfig
from repro.modelserver import ModelRegistry as JModelRegistry
from repro.modelserver import TrainerConfig as JTrainerConfig
from repro.service import MOOService as JMOOService
from repro_torch.core import MOGDConfig, Objective, continuous
from repro_torch.core.frontier_store import FrontierStore
from repro_torch.core.progressive_frontier import (
    ProgressiveFrontier,
    export_pf_state,
    import_pf_state,
    live_seed_points,
)
from repro_torch.core.synthetic import make_sphere2, sphere2_task
from repro_torch.models.convert import program_from_numpy
from repro_torch.persist import (
    FrontierVault,
    entry_id,
    read_entry,
    write_entry,
)
from repro_torch.persist.store import is_entry, sweep_tmp
from repro_torch.runtime import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.runtime.checkpoint import latest_step
from repro_torch.service import MOOService

CPU = "cpu"
FAST = MOGDConfig(steps=50, multistart=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# store layer: atomic commit, integrity, crash hygiene
# ---------------------------------------------------------------------
class TestStore:
    def test_write_read_roundtrip(self, tmp_path):
        arrays = {"F": np.arange(6.0).reshape(3, 2),
                  "mask": np.array([True, False, True])}
        meta = {"workload": "w1", "nested": {"k": [1, 2]}}
        p = write_entry(tmp_path, "e1", arrays, meta)
        assert is_entry(p)
        got_arrays, got_meta = read_entry(p)
        np.testing.assert_array_equal(got_arrays["F"], arrays["F"])
        np.testing.assert_array_equal(got_arrays["mask"], arrays["mask"])
        assert got_meta["workload"] == "w1"
        assert got_meta["nested"] == {"k": [1, 2]}

    def test_checksum_corruption_raises(self, tmp_path):
        p = write_entry(tmp_path, "e1", {"x": np.ones(4)}, {})
        data = p / "data.npz"
        raw = bytearray(data.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        data.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="checksum"):
            read_entry(p, verify=True)

    def test_crash_mid_write_invisible_and_swept(self, tmp_path,
                                                 monkeypatch):
        """A writer dying before the manifest lands leaves a ``.tmp-``
        dir that is not an entry and that ``sweep_tmp`` removes."""
        import repro_torch.persist.store as store

        def boom(*a, **kw):
            raise OSError("disk gone")

        monkeypatch.setattr(store.np, "savez", boom)
        with pytest.raises(OSError, match="disk gone"):
            write_entry(tmp_path, "e1", {"x": np.ones(2)}, {})
        monkeypatch.undo()
        # no committed entry, nothing loadable
        assert not (tmp_path / "e1").exists()
        leftovers = list(tmp_path.iterdir())
        assert all(not is_entry(d) for d in leftovers)
        sweep_tmp(tmp_path)
        assert list(tmp_path.iterdir()) == []

    def test_overwrite_semantics(self, tmp_path):
        write_entry(tmp_path, "e1", {"x": np.zeros(2)}, {"gen": 1})
        with pytest.raises(FileExistsError):
            write_entry(tmp_path, "e1", {"x": np.ones(2)}, {"gen": 2},
                        overwrite=False)
        _, meta = read_entry(tmp_path / "e1")
        assert meta["gen"] == 1  # refused write changed nothing
        write_entry(tmp_path, "e1", {"x": np.ones(2)}, {"gen": 2})
        arrays, meta = read_entry(tmp_path / "e1")
        assert meta["gen"] == 2
        np.testing.assert_array_equal(arrays["x"], np.ones(2))
        # no .old- sibling left behind
        assert [d.name for d in tmp_path.iterdir()] == ["e1"]

    def test_entry_id_content_addressed(self):
        assert entry_id("frontier", "sig-a") == entry_id("frontier", "sig-a")
        assert entry_id("frontier", "sig-a") != entry_id("frontier", "sig-b")
        assert entry_id("frontier", "s") != entry_id("model", "s")
        # the reference's ids: an entry one package names the other finds
        assert entry_id("frontier", "sig-a") == JP.entry_id("frontier",
                                                            "sig-a")


# ---------------------------------------------------------------------
# codecs: FrontierStore / PFState round-trips
# ---------------------------------------------------------------------
class TestPFStateCodec:
    def _state(self, probes=60):
        problem = make_sphere2(device=CPU)
        engine = ProgressiveFrontier(problem, mode="AP", mogd=FAST,
                                     grid_l=2, batch_rects=2, device=CPU)
        return engine, engine.run(n_probes=probes)

    def test_frontier_store_roundtrip_and_continued_adds(self):
        rng = np.random.default_rng(0)
        store = FrontierStore(k=2, dim=3, device=CPU)
        F = rng.random((40, 2))
        X = rng.random((40, 3))
        store.add(F, X)
        arrays, meta = store.state_dict()
        clone = FrontierStore.from_state(arrays, meta, device=CPU)
        f1, x1 = store.frontier()
        f2, x2 = clone.frontier()
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(x1, x2)
        assert clone.total_offered == store.total_offered
        assert clone.total_accepted == store.total_accepted
        # the clone keeps absorbing: duplicates still dedup, dominated
        # rows still die — internal keys/masks survived the round-trip
        before = clone.n_points
        clone.add(f1[:3], x1[:3])
        assert clone.n_points == before  # exact duplicates refused
        clone.add(np.full((1, 2), -1.0), np.zeros((1, 3)))
        assert clone.n_points == 1  # dominator swept the frontier

    def test_pf_state_roundtrip(self):
        engine, res = self._state()
        st = res.state
        arrays, meta = export_pf_state(st)
        clone = import_pf_state(arrays, meta, device=CPU)
        f1, x1 = st.store.frontier()
        f2, x2 = clone.store.frontier()
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(x1, x2)
        assert clone.probes == st.probes
        assert len(clone.queue) == len(st.queue)
        # Def 3.7 uncertain fraction must RESUME, not reset: the queue's
        # initial volume is part of the durable state
        assert clone.queue.uncertain_fraction == pytest.approx(
            st.queue.uncertain_fraction)
        np.testing.assert_array_equal(clone.utopia, st.utopia)
        np.testing.assert_array_equal(clone.nadir, st.nadir)
        assert clone.trace == st.trace

    def test_restored_state_keeps_solving(self):
        engine, res = self._state(probes=40)
        arrays, meta = export_pf_state(res.state)
        clone_state = engine.import_state(arrays, meta)
        before = clone_state.store.n_points
        out = engine.run(n_probes=40, state=clone_state)
        assert out.state.probes > meta["probes"]
        assert out.state.store.n_points >= before

    def test_bounded_store_roundtrip_keeps_excluding(self):
        """Declared objective bounds and the infeasible ledger survive:
        the restored store keeps mark-and-excluding out-of-bounds offers."""
        store = FrontierStore(k=2, dim=2,
                              bounds=np.array([[0.0, 1.0], [0.0, 1.0]]),
                              device=CPU)
        store.add(np.array([[0.5, 0.5], [2.0, 0.1]]), np.zeros((2, 2)))
        assert store.total_infeasible == 1
        arrays, meta = store.state_dict()
        clone = FrontierStore.from_state(arrays, meta, device=CPU)
        assert clone.total_infeasible == 1
        assert clone.n_points == store.n_points
        clone.add(np.array([[0.1, 5.0]]), np.ones((1, 2)))  # over bound
        assert clone.total_infeasible == 2
        assert clone.n_points == store.n_points  # excluded, not stored

    def test_live_seed_points_excludes_dead_rows(self):
        store = FrontierStore(k=2, dim=2, device=CPU)
        # second point dominates the first -> first row goes dead
        store.add(np.array([[1.0, 1.0]]), np.zeros((1, 2)))
        store.add(np.array([[0.5, 0.5]]), np.ones((1, 2)))
        arrays, meta = store.state_dict()
        X = live_seed_points({f"store/{k}": v for k, v in arrays.items()})
        np.testing.assert_array_equal(X, np.ones((1, 2)))


# ---------------------------------------------------------------------
# vault: lifecycle, tombstones, write-behind
# ---------------------------------------------------------------------
class TestVault:
    def _arrays(self, seed=0):
        rng = np.random.default_rng(seed)
        return {"F": rng.random((4, 2))}

    def test_put_get_roundtrip_and_overwrite(self, tmp_path):
        with FrontierVault(tmp_path, write_behind=False) as v:
            assert v.put_frontier("sig-a", self._arrays(), {"probes": 9},
                                  workload="w", version=1)
            arrays, meta = v.get_frontier("sig-a")
            np.testing.assert_array_equal(arrays["F"], self._arrays()["F"])
            assert meta["probes"] == 9
            assert meta["workload"] == "w" and meta["version"] == 1
            # snapshots of the same key overwrite (newer frontier wins)
            v.put_frontier("sig-a", self._arrays(1), {"probes": 20},
                           workload="w", version=1)
            _, meta = v.get_frontier("sig-a")
            assert meta["probes"] == 20
            assert len(v.frontier_entries()) == 1

    def test_miss_returns_none(self, tmp_path):
        with FrontierVault(tmp_path, write_behind=False) as v:
            assert v.get_frontier("nope") is None
            assert v.latest_for_workload("nope") is None

    def test_tombstone_deletes_and_blocks_future_puts(self, tmp_path):
        with FrontierVault(tmp_path, write_behind=False) as v:
            v.put_frontier("sig-a", self._arrays(), {}, workload="w",
                           version=1)
            v.put_frontier("sig-b", self._arrays(1), {}, workload="w",
                           version=2)
            v.put_frontier("sig-c", self._arrays(2), {}, workload="other",
                           version=1)
            killed = v.tombstone_workload("w", version=2, reason="drift")
            assert killed == 2
            assert v.get_frontier("sig-a") is None
            assert v.get_frontier("sig-b") is None
            assert v.get_frontier("sig-c") is not None  # other workload
            # a late write-behind put from the dead regime is refused...
            assert not v.put_frontier("sig-a", self._arrays(), {},
                                      workload="w", version=2)
            # ...but a post-promotion (higher-version) frontier passes
            assert v.put_frontier("sig-d", self._arrays(3), {},
                                  workload="w", version=3)

    def test_tombstone_survives_restart(self, tmp_path):
        with FrontierVault(tmp_path, write_behind=False) as v:
            v.put_frontier("sig-a", self._arrays(), {}, workload="w",
                           version=1)
            v.tombstone_workload("w", version=1)
        with FrontierVault(tmp_path, write_behind=False) as v2:
            assert v2.get_frontier("sig-a") is None
            assert not v2.put_frontier("sig-a", self._arrays(), {},
                                       workload="w", version=1)

    def test_latest_for_workload_picks_highest_version(self, tmp_path):
        with FrontierVault(tmp_path, write_behind=False) as v:
            v.put_frontier("sig-1", self._arrays(1), {}, workload="w",
                           version=1)
            v.put_frontier("sig-3", self._arrays(3), {}, workload="w",
                           version=3)
            v.put_frontier("sig-2", self._arrays(2), {}, workload="w",
                           version=2)
            arrays, meta = v.latest_for_workload("w")
            assert meta["version"] == 3
            # exclude_version skips the exact-match tier's own entry
            arrays, meta = v.latest_for_workload("w", exclude_version=3)
            assert meta["version"] == 2

    def test_write_behind_flush(self, tmp_path):
        with FrontierVault(tmp_path, write_behind=True) as v:
            for i in range(8):
                v.put_frontier(f"sig-{i}", self._arrays(i), {"i": i})
            v.flush()
            assert v.stats()["writes"] == 8
            assert v.stats()["write_errors"] == 0
            for i in range(8):
                _, meta = v.get_frontier(f"sig-{i}")
                assert meta["i"] == i

    def test_corrupt_entry_raises_on_verify(self, tmp_path):
        with FrontierVault(tmp_path, write_behind=False) as v:
            v.put_frontier("sig-a", self._arrays(), {})
            path = v.frontiers_dir / FrontierVault.frontier_key("sig-a")
            raw = bytearray((path / "data.npz").read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            (path / "data.npz").write_bytes(bytes(raw))
            with pytest.raises(IOError, match="checksum"):
                v.get_frontier("sig-a")

    def test_open_sweeps_stranded_tmp_dirs(self, tmp_path):
        v = FrontierVault(tmp_path, write_behind=False)
        v.put_frontier("sig-a", self._arrays(), {})
        v.close()
        stranded = v.frontiers_dir / "abc.tmp-dead"
        stranded.mkdir()
        (stranded / "data.npz").write_bytes(b"partial")
        v2 = FrontierVault(tmp_path, write_behind=False)
        assert not stranded.exists()
        assert v2.get_frontier("sig-a") is not None
        v2.close()


# ---------------------------------------------------------------------
# service integration: snapshot -> cold restart -> warm start
# ---------------------------------------------------------------------
class TestServiceRestart:
    def _service(self, root, **kw):
        kw.setdefault("mogd", FAST)
        kw.setdefault("batch_rects", 2)
        kw.setdefault("grid_l", 2)
        return MOOService(vault=FrontierVault(root, write_behind=False),
                          device=CPU, **kw)

    def test_close_persists_and_restart_restores(self, tmp_path):
        svc = self._service(tmp_path)
        sid = svc.create_session(sphere2_task(device=CPU))
        svc.run_until(min_probes=14)
        F1, X1 = svc.frontier(sid)
        probes1 = svc.session_info(sid).probes
        svc.close_session(sid)
        assert svc.stats()["vault_snapshots"] >= 1

        svc2 = self._service(tmp_path)
        sid2 = svc2.create_session(sphere2_task(device=CPU))
        assert svc2.stats()["vault_restores"] == 1
        # the restored frontier is served with ZERO executor dispatches
        assert svc2.stats()["executor_dispatches"] == 0
        F2, X2 = svc2.frontier(sid2)
        np.testing.assert_array_equal(np.sort(F1, axis=0),
                                      np.sort(F2, axis=0))
        np.testing.assert_array_equal(np.sort(X1, axis=0),
                                      np.sort(X2, axis=0))
        info = svc2.session_info(sid2)
        assert info.probes == probes1  # probe ledger resumed, not reset
        rec = svc2.recommend(sid2)
        assert rec.frontier_size == len(F2)
        assert svc2.stats()["executor_dispatches"] == 0

    def test_restored_session_keeps_probing(self, tmp_path):
        svc = self._service(tmp_path)
        sid = svc.create_session(sphere2_task(device=CPU))
        svc.run_until(min_probes=14)
        probes1 = svc.session_info(sid).probes
        svc.close_session(sid)
        svc2 = self._service(tmp_path)
        sid2 = svc2.create_session(sphere2_task(device=CPU))
        out = svc2.step_all(rounds=2)
        assert out["probes"] > 0
        assert svc2.session_info(sid2).probes > probes1

    def test_autosave_fires_on_probe_budget(self, tmp_path):
        svc = self._service(tmp_path, vault_autosave_probes=8)
        svc.create_session(sphere2_task(device=CPU))
        svc.run_until(min_probes=30)
        assert svc.stats()["vault_snapshots"] >= 2

    def test_vaultless_service_unchanged(self, tmp_path):
        svc = MOOService(mogd=FAST, batch_rects=2, grid_l=2, device=CPU)
        sid = svc.create_session(sphere2_task(device=CPU))
        svc.run_until(min_probes=14)
        st = svc.stats()
        assert st["vault_snapshots"] == 0 and st["vault_restores"] == 0
        svc.close_session(sid)


# ---------------------------------------------------------------------
# registry rehydration + drift tombstones (the modelserver tier)
# ---------------------------------------------------------------------
def _truth(X, shift=False):
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    a = 3.0 if shift else 1.0
    y1 = a * (X[:, 0] - 0.3) ** 2 + X[:, 1] + 0.5
    y2 = 1.5 - X[:, 0] + 0.2 * X[:, 1] ** 2 + (1.0 if shift else 0.0)
    return np.stack([y1, y2], axis=1)


def _predict(models, X) -> np.ndarray:
    x = torch.as_tensor(np.asarray(X, np.float32))
    return np.asarray([m(x).detach().numpy() for m in models])


class TestRegistryRehydration:
    KNOBS = (continuous("a", 0.0, 1.0), continuous("b", 0.0, 1.0))
    OBJECTIVES = (Objective("lat"), Objective("cost"))

    def _registry(self, vault=None):
        from repro_torch.modelserver import (
            DriftConfig,
            ModelRegistry,
            TrainerConfig,
        )
        return ModelRegistry(
            trainer=TrainerConfig(hidden=(24, 24), max_epochs=30, seed=0),
            drift=DriftConfig(window=16, min_obs=8, mult=3.0, floor=0.1),
            trim_on_drift=16, vault=vault, device=CPU)

    def _trained(self, vault):
        rng = np.random.default_rng(0)
        reg = self._registry(vault)
        w = reg.register_workload(("toy", "w1"), self.KNOBS,
                                  self.OBJECTIVES)
        X = rng.random((160, 2))
        reg.observe_batch(w, X, _truth(X))
        rep = reg.retrain(w)
        assert rep.improved
        return reg, w, rng

    def _service(self, vault):
        return MOOService(mogd=FAST, batch_rects=2, grid_l=2, vault=vault,
                          device=CPU)

    def test_rehydrated_signature_is_bit_exact(self, tmp_path):
        vault = FrontierVault(tmp_path, write_behind=False)
        reg, w, _ = self._trained(vault)
        assert reg.workloads_persisted == 1
        reg2 = self._registry(FrontierVault(tmp_path, write_behind=False))
        assert reg2.rehydrate() == [w]
        assert reg2.workloads_rehydrated == 1
        s1 = reg.task_spec(w)
        s2 = reg2.task_spec(w)
        # the whole warm-restart chain hangs on this equality: the vault
        # keys frontiers by task signature, so a rehydrated registry must
        # reproduce it bit-exactly
        assert s1.signature() == s2.signature()
        # and the rehydrated model predicts identically
        X = np.random.default_rng(1).random((5, 2))
        p1 = _predict(reg._get(w).active.models, X)
        p2 = _predict(reg2._get(w).active.models, X)
        np.testing.assert_allclose(p1, p2, rtol=1e-12)

    def test_live_registry_wins_over_vault(self, tmp_path):
        vault = FrontierVault(tmp_path, write_behind=False)
        reg, w, _rng = self._trained(vault)
        # rehydrating into a registry that already has the workload
        # leaves the live record untouched
        before = reg._get(w).active
        assert reg.rehydrate(vault) == []
        assert reg._get(w).active is before

    def test_workload_restart_restores_frontier(self, tmp_path):
        vault = FrontierVault(tmp_path, write_behind=False)
        reg, w, _ = self._trained(vault)
        svc = self._service(vault)
        sid = svc.create_workload_session(reg, w)
        svc.run_until(min_probes=14)
        F1, _ = svc.frontier(sid)
        svc.close_session(sid)

        vault2 = FrontierVault(tmp_path, write_behind=False)
        reg2 = self._registry(vault2)
        reg2.rehydrate()
        svc2 = self._service(vault2)
        sid2 = svc2.create_workload_session(reg2, w)
        assert svc2.stats()["vault_restores"] == 1
        F2, _ = svc2.frontier(sid2)
        np.testing.assert_array_equal(np.sort(F1, axis=0),
                                      np.sort(F2, axis=0))

    def test_drift_tombstones_vault_and_blocks_restart(self, tmp_path):
        vault = FrontierVault(tmp_path, write_behind=False)
        reg, w, rng = self._trained(vault)
        svc = self._service(vault)
        sid = svc.create_workload_session(reg, w)
        svc.run_until(min_probes=14)
        svc.close_session(sid)
        assert vault.latest_for_workload(w) is not None

        # shifted regime -> drift event -> synchronous tombstone
        X = rng.random((60, 2))
        drifted = False
        for i in range(len(X)):
            evs = reg.observe(w, X[i], _truth(X[i:i + 1], shift=True)[0])
            if any(e.kind == "drift" for e in evs):
                drifted = True
                break
        assert drifted
        assert svc.stats()["vault_tombstones"] >= 1
        assert vault.latest_for_workload(w) is None

        # a cold restart after drift must solve fresh — a stale frontier
        # from the dead regime is never served
        vault2 = FrontierVault(tmp_path, write_behind=False)
        reg2 = self._registry(vault2)
        reg2.rehydrate()
        svc2 = self._service(vault2)
        svc2.create_workload_session(reg2, w)
        st = svc2.stats()
        assert st["vault_restores"] == 0 and st["vault_seeds"] == 0


# ---------------------------------------------------------------------
# checkpoints (tests/test_runtime.py::TestCheckpoint)
# ---------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "b": torch.zeros(16)},
        "opt": {"mu": {"w": torch.ones((8, 16)), "b": torch.zeros(16)},
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    """The leaves in the checkpoint's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        t = _tree()
        save_checkpoint(tmp_path, 10, t, extra={"loss": 1.5})
        out, manifest = load_checkpoint(tmp_path, t)
        assert manifest["step"] == 10
        assert manifest["extra"]["loss"] == 1.5
        _assert_trees_equal(t, out)
        assert out["opt"]["count"].dtype is torch.int32

    def test_latest_step_picks_max(self, tmp_path):
        t = _tree()
        for s in (5, 20, 15):
            save_checkpoint(tmp_path, s, t)
        assert latest_step(tmp_path) == 20

    def test_corruption_detected(self, tmp_path):
        t = _tree()
        d = save_checkpoint(tmp_path, 1, t)
        shard = d / "shard_00000.npz"
        data = bytearray(shard.read_bytes())
        data[len(data) // 2] ^= 0xFF
        shard.write_bytes(bytes(data))
        with pytest.raises(IOError, match="checksum"):
            load_checkpoint(tmp_path, t)

    def test_incomplete_write_invisible(self, tmp_path):
        """A tmp dir without manifest must not be picked up."""
        t = _tree()
        save_checkpoint(tmp_path, 1, t)
        fake = tmp_path / "step_00000099.tmp-abc"
        fake.mkdir()
        (fake / "shard_00000.npz").write_bytes(b"garbage")
        assert latest_step(tmp_path) == 1

    def test_shape_mismatch_rejected(self, tmp_path):
        t = _tree()
        save_checkpoint(tmp_path, 1, t)
        bad = {k: {kk: (torch.zeros((3, 3)) if not isinstance(vv, dict)
                        else {k3: torch.zeros((3, 3)) for k3 in vv})
                   for kk, vv in v.items()} for k, v in t.items()}
        with pytest.raises(ValueError, match="shape"):
            load_checkpoint(tmp_path, bad)

    def test_restore_onto_target_device_and_dtype(self, tmp_path):
        """The one-device counterpart of the reference's restore onto a
        target sharding: every leaf lands on its ``like`` leaf's device
        and in its dtype."""
        t = {"w": torch.arange(16.0).reshape(4, 4),
             "n": torch.tensor([1, 2], dtype=torch.int64)}
        save_checkpoint(tmp_path, 1, t)
        like = {"w": torch.zeros((4, 4), dtype=torch.float64),
                "n": torch.zeros(2, dtype=torch.int32)}
        out, _ = load_checkpoint(tmp_path, like)
        assert out["w"].dtype is torch.float64 and out["w"].device.type == CPU
        assert out["n"].dtype is torch.int32
        np.testing.assert_array_equal(out["w"].numpy(), t["w"].numpy())

    def test_async_manager_and_retention(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save_async(s, _tree(s))
        mgr.wait()
        steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir()
                       if d.name.startswith("step_"))
        assert steps == [3, 4]
        out, manifest = mgr.restore_latest(_tree())
        assert manifest["step"] == 4
        _assert_trees_equal(out, _tree(4))

    def test_resave_refused_before_tmp_write(self, tmp_path):
        """``overwrite=False`` on an existing step short-circuits BEFORE
        any tmp dir is created — a refused re-save costs nothing and
        leaks nothing."""
        t = _tree()
        save_checkpoint(tmp_path, 7, t)
        before = sorted(p.name for p in tmp_path.iterdir())
        with pytest.raises(FileExistsError):
            save_checkpoint(tmp_path, 7, _tree(1))
        after = sorted(p.name for p in tmp_path.iterdir())
        assert after == before  # no tmp dir, no partial data

    def test_resave_overwrite_replaces_atomically(self, tmp_path):
        t1, t2 = _tree(1), _tree(2)
        save_checkpoint(tmp_path, 7, t1, extra={"gen": 1})
        save_checkpoint(tmp_path, 7, t2, extra={"gen": 2}, overwrite=True)
        out, manifest = load_checkpoint(tmp_path, t2)
        assert manifest["extra"]["gen"] == 2
        _assert_trees_equal(t2, out)
        # the old step dir was removed, not left as a sibling
        dirs = [p.name for p in tmp_path.iterdir() if p.is_dir()]
        assert dirs == ["step_00000007"]

    def test_crash_mid_write_leaves_no_loadable_dir(self, tmp_path,
                                                    monkeypatch):
        """A writer dying before the manifest lands must leave nothing
        that latest_step/load will pick up, and the manager's gc sweep
        removes any orphaned tmp dir a hard crash would strand."""
        t = _tree()
        save_checkpoint(tmp_path, 1, t)

        import repro_torch.runtime.checkpoint as ckpt

        def boom(*a, **kw):
            raise OSError("disk gone")

        monkeypatch.setattr(ckpt.np, "savez", boom)
        with pytest.raises(OSError, match="disk gone"):
            save_checkpoint(tmp_path, 2, t)
        monkeypatch.undo()
        assert latest_step(tmp_path) == 1  # step 2 never became visible
        # simulate a HARD crash: a stranded tmp dir with partial data
        stranded = tmp_path / "step_00000003.tmp-deadbeef"
        stranded.mkdir()
        (stranded / "shard_00000.npz").write_bytes(b"partial")
        mgr = CheckpointManager(tmp_path, keep=2)
        mgr.save_async(4, t)
        mgr.wait()
        assert not stranded.exists()  # swept by gc
        assert latest_step(tmp_path) == 4

    def test_async_failure_raises_with_step_attribution(self, tmp_path,
                                                        monkeypatch):
        """A failed background write surfaces as CheckpointError naming
        the failed step — on the next wait() or save_async(), never
        silently swallowed by an interleaved save."""
        from repro_torch.runtime.checkpoint import CheckpointError

        import repro_torch.runtime.checkpoint as ckpt

        real_savez = ckpt.np.savez
        calls = []

        def flaky(path, **arrs):
            calls.append(str(path))
            if "step_00000002" in str(path):
                raise OSError("transient")
            return real_savez(path, **arrs)

        monkeypatch.setattr(ckpt.np, "savez", flaky)
        mgr = CheckpointManager(tmp_path, keep=5)
        mgr.save_async(1, _tree(1))
        mgr.save_async(2, _tree(2))  # this write will fail...
        with pytest.raises(CheckpointError) as ei:
            mgr.save_async(3, _tree(3))  # ...and raise HERE, attributed
        assert ei.value.steps == [2]
        # after the raise the manager is clean and usable again
        mgr.save_async(3, _tree(3))
        mgr.wait()
        assert latest_step(tmp_path) == 3


# ---------------------------------------------------------------------
# the on-disk formats across the two packages
# ---------------------------------------------------------------------
def _mlp_tasks():
    """(reference TaskSpec, port TaskSpec) over the same MLP weights."""
    jt = JS.mlp_surrogate_task(seed=0)
    params = jax.tree_util.tree_map(np.asarray, jt.program.params)
    prog = program_from_numpy(jt.program.structure, params, device=CPU)
    pt = P.TaskSpec(knobs=P.mlp_surrogate_task(device=CPU).knobs,
                    objectives=jt.objectives, program=prog, name=jt.name,
                    device=CPU)
    return jt, pt


def _same_state(port_state, ref_state):
    """The port's restored state equals the reference's, exactly."""
    p_arrays, p_meta = export_pf_state(port_state)
    j_arrays, j_meta = j_export(ref_state)
    assert sorted(p_arrays) == sorted(j_arrays)
    for k in j_arrays:
        np.testing.assert_array_equal(p_arrays[k], j_arrays[k], err_msg=k)
        assert np.asarray(p_arrays[k]).dtype == np.asarray(j_arrays[k]).dtype
    assert p_meta == j_meta
    pf, px = port_state.store.frontier()
    jf, jx = ref_state.store.frontier()
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(px, jx)
    assert len(port_state.queue) == len(ref_state.queue)
    assert (port_state.queue.initial_volume
            == ref_state.queue.initial_volume)


class TestCrossPackage:
    def test_reference_entry_restores_in_port(self, tmp_path):
        jt, pt = _mlp_tasks()
        jengine = J.ProgressiveFrontier(
            J.as_problem(jt), mode="AP", grid_l=2, batch_rects=2,
            mogd=J.MOGDConfig(steps=50, multistart=4))
        jstate = jengine.run(n_probes=30).state
        arrays, meta = j_export(jstate)
        with JP.FrontierVault(tmp_path, write_behind=False) as jv:
            assert jv.put_frontier("task", arrays, meta)
            # the same entry under the port task's signature, for the
            # service's exact-signature restore below
            assert jv.put_frontier(pt.signature(), arrays, meta)
        vault = FrontierVault(tmp_path, write_behind=False)
        got_arrays, got_meta = vault.get_frontier("task")
        pengine = P.ProgressiveFrontier(
            P.as_problem(pt), mode="AP", grid_l=2, batch_rects=2,
            mogd=P.MOGDConfig(steps=50, multistart=4), use_kernel=True,
            device=CPU)
        restored = pengine.import_state(got_arrays, got_meta)
        assert restored.store.n_points >= 1
        _same_state(restored, jstate)
        # a port service restores it with no dispatch, and serves it
        svc = MOOService(mogd=P.MOGDConfig(steps=50, multistart=4),
                         grid_l=2, batch_rects=2, use_kernel=True,
                         vault=vault, device=CPU)
        sid = svc.create_session(pt)
        st = svc.stats()
        assert st["vault_restores"] == 1 and st["executor_dispatches"] == 0
        np.testing.assert_array_equal(svc.frontier(sid)[0],
                                      jstate.store.frontier()[0])
        assert svc.recommend(sid).frontier_size == jstate.store.n_points
        # and the restored state keeps solving in the port
        out = pengine.run(n_probes=12, state=restored)
        assert out.probes > jstate.probes

    def test_port_entry_restores_in_reference(self, tmp_path):
        jt, pt = _mlp_tasks()
        pengine = P.ProgressiveFrontier(
            P.as_problem(pt), mode="AP", grid_l=2, batch_rects=2,
            mogd=P.MOGDConfig(steps=50, multistart=4), use_kernel=True,
            device=CPU)
        pstate = pengine.run(n_probes=30).state
        arrays, meta = export_pf_state(pstate)
        with FrontierVault(tmp_path, write_behind=False) as pv:
            assert pv.put_frontier("task", arrays, meta)
            assert pv.put_frontier(jt.signature(), arrays, meta)
        jvault = JP.FrontierVault(tmp_path, write_behind=False)
        got_arrays, got_meta = jvault.get_frontier("task")
        jengine = J.ProgressiveFrontier(
            J.as_problem(jt), mode="AP", grid_l=2, batch_rects=2,
            mogd=J.MOGDConfig(steps=50, multistart=4))
        jrestored = jengine.import_state(got_arrays, got_meta)
        assert jrestored.store.n_points >= 1
        _same_state(pstate, jrestored)
        jsvc = JMOOService(mogd=J.MOGDConfig(steps=50, multistart=4),
                           grid_l=2, batch_rects=2, vault=jvault)
        sid = jsvc.create_session(jt)
        st = jsvc.stats()
        assert st["vault_restores"] == 1 and st["executor_dispatches"] == 0
        np.testing.assert_array_equal(jsvc.frontier(sid)[0],
                                      pstate.store.frontier()[0])

    def _ref_registry(self, vault, backend):
        return JModelRegistry(
            trainer=JTrainerConfig(backend=backend, hidden=(24, 24),
                                   max_epochs=30, seed=0),
            drift=JDriftConfig(window=16, min_obs=8, mult=3.0, floor=0.1),
            trim_on_drift=16, vault=vault)

    def _port_registry(self, vault, backend):
        from repro_torch.modelserver import (
            DriftConfig,
            ModelRegistry,
            TrainerConfig,
        )
        return ModelRegistry(
            trainer=TrainerConfig(backend=backend, hidden=(24, 24),
                                  max_epochs=30, seed=0),
            drift=DriftConfig(window=16, min_obs=8, mult=3.0, floor=0.1),
            trim_on_drift=16, vault=vault, device=CPU)

    @pytest.mark.parametrize("backend", ["mlp", "gp"])
    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_workload_rehydrates_across(self, tmp_path, backend, writer):
        """A workload record persisted by one package's registry (one
        promotion) rehydrates in the other's: the same signature, key,
        knobs, objectives, traces, lineage and model identity, and the
        same predictions (1e-5)."""
        rng = np.random.default_rng(0)
        X = rng.random((160, 2))
        Y = _truth(X)
        if writer == "reference":
            jv = JP.FrontierVault(tmp_path, write_behind=False)
            src = self._ref_registry(jv, backend)
            w = src.register_workload(
                ("toy", "w1"), (J.continuous("a", 0.0, 1.0),
                                J.continuous("b", 0.0, 1.0)),
                (J.Objective("lat"), J.Objective("cost")))
            dst = self._port_registry(
                FrontierVault(tmp_path, write_behind=False), backend)
        else:
            src = self._port_registry(
                FrontierVault(tmp_path, write_behind=False), backend)
            w = src.register_workload(("toy", "w1"),
                                      TestRegistryRehydration.KNOBS,
                                      TestRegistryRehydration.OBJECTIVES)
            dst = self._ref_registry(
                JP.FrontierVault(tmp_path, write_behind=False), backend)
        src.observe_batch(w, X, Y)
        assert src.retrain(w).improved and src.workloads_persisted == 1
        assert dst.rehydrate() == [w] and dst.workloads_rehydrated == 1
        a, b = src._get(w), dst._get(w)
        assert (b.sig, b.key, b.name) == (a.sig, a.key, a.name)
        assert repr(b.knobs) == repr(a.knobs)
        assert repr(b.objectives) == repr(a.objectives)
        np.testing.assert_array_equal(np.asarray(b.X), np.asarray(a.X))
        np.testing.assert_array_equal(np.asarray(b.Y), np.asarray(a.Y))
        assert [s.version for s in b.snapshots] == [1]
        assert src.task_spec(w).model_id == dst.task_spec(w).model_id == (
            "modelserver", w, 1)
        Xq = np.random.default_rng(1).random((7, 2))

        def preds(models, port):
            if port:
                return _predict(models, Xq)
            return np.asarray([np.asarray(m(jnp.asarray(Xq, jnp.float32)))
                               for m in models])

        np.testing.assert_allclose(
            preds(b.active.models, writer == "reference"),
            preds(a.active.models, writer == "port"), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_fp32_checkpoint_loads_across(self, tmp_path, writer):
        """fp32 and int32 leaves, nested dicts, a list and a tuple: the
        other package loads them exactly, and both write the same leaf
        keys, shapes, dtypes and tree notation."""
        rng = np.random.default_rng(3)
        w = rng.normal(size=(8, 16)).astype(np.float32)
        b = rng.normal(size=(16,)).astype(np.float32)
        layers = [rng.normal(size=(4, 4)).astype(np.float32)
                  for _ in range(2)]

        def tree(to, count):
            return {"params": {"w": to(w), "b": to(b),
                               "layers": [to(x) for x in layers]},
                    "opt": {"count": count, "pair": (to(b), to(w))}}

        jtree = tree(jnp.asarray, jnp.int32(7))
        ptree = tree(torch.as_tensor, torch.tensor(7, dtype=torch.int32))
        jdir, pdir = tmp_path / "ref", tmp_path / "port"
        JR.save_checkpoint(jdir, 3, jtree, extra={"loss": 1.5})
        save_checkpoint(pdir, 3, ptree, extra={"loss": 1.5})
        jman = json.loads((jdir / "step_00000003/manifest.json").read_text())
        pman = json.loads((pdir / "step_00000003/manifest.json").read_text())
        for key in ("leaves", "treedef", "extra", "step"):
            assert pman[key] == jman[key], key
        if writer == "reference":
            out, man = load_checkpoint(jdir, ptree)
            assert out["opt"]["count"].dtype is torch.int32
            assert isinstance(out["opt"]["pair"], tuple)
        else:
            out, man = JR.load_checkpoint(pdir, jtree)
        assert man["extra"]["loss"] == 1.5
        _assert_trees_equal(out, ptree)

    def test_bf16_checkpoint(self, tmp_path):
        """bf16 leaves are written as the reference writes them (raw
        ``V2`` bytes, ``"bfloat16"`` in the manifest); the port reads its
        own and the reference's back bit for bit; the reference's own
        load of a bf16 leaf raises (numpy has no cast from ``V2``)."""
        vals = np.random.default_rng(4).normal(size=(4, 8)).astype(
            np.float32)
        pt = {"w": torch.as_tensor(vals).to(torch.bfloat16),
              "s": torch.ones(3)}
        save_checkpoint(tmp_path / "port", 1, pt)
        out, man = load_checkpoint(tmp_path / "port", pt)
        assert man["leaves"]["w"]["dtype"] == "bfloat16"
        assert out["w"].dtype is torch.bfloat16
        assert torch.equal(out["w"].view(torch.int16),
                           pt["w"].view(torch.int16))
        jt = {"w": jnp.asarray(vals).astype(jnp.bfloat16), "s": jnp.ones(3)}
        d = JR.save_checkpoint(tmp_path / "ref", 1, jt)
        jman = json.loads((d / "manifest.json").read_text())
        assert jman["leaves"] == man["leaves"]
        out, _ = load_checkpoint(tmp_path / "ref", pt)
        assert torch.equal(out["w"].view(torch.int16),
                           pt["w"].view(torch.int16))
        # a numpy ``like`` leaf takes the values in its own dtype
        out, _ = load_checkpoint(tmp_path / "ref",
                                 {"w": np.zeros((4, 8), np.float32),
                                  "s": np.zeros(3, np.float32)})
        np.testing.assert_array_equal(
            out["w"], pt["w"].float().numpy())
        for src in ("ref", "port"):
            with pytest.raises(ValueError):
                JR.load_checkpoint(tmp_path / src, jt)
