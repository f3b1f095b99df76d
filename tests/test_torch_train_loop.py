"""The port's training loop on the CPU: the reference's
tests/test_train_loop.py and the training half of tests/test_faults.py,
case for case, plus the data pipeline against the reference's.

Convergence, a NodeFailure restart that resumes bit for bit (losses and
every final param), the restore through the state policy's program equal
to the plain restore, a mid-run mesh change, a stale policy for a larger
mesh recovered, a kill mid-restore then a clean restart, too many
failures raising, a foreign checkpoint named as a schema mismatch, the
straggler watchdog, ``run_elastic`` and ``trajectory_diff``;
``SyntheticLM`` bit-equal to the reference's over steps, ranks and worlds,
the ``Prefetcher``; and the CLI (``python -m repro_torch.launch.train
--smoke --device cpu``), for llama and for the ssm, hybrid, MoE and vlm
smoke models.
"""
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro.data import SyntheticLM as RSyntheticLM

from repro_torch import NoCudaDeviceError
from repro_torch.core import tree_leaves
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.models import registry
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import (InjectedFault, NodeFailure, RestoreError,
                                 StragglerWatchdog, faults, make_train_step,
                                 run, run_elastic, train_state,
                                 trajectory_diff)
from repro_torch.runtime.train import state_transfer_policy

CPU = "cpu"


@pytest.fixture(scope="module")
def setup():
    api = registry.get("llama3.2-1b", smoke=True)
    opt = make_optimizer("adamw")
    step = make_train_step(api, opt, constant(1e-2))
    data = SyntheticLM(api.cfg.vocab_size, seq_len=32, global_batch=4)
    return api, opt, step, data


def _init(api, opt, seed):
    return lambda: train_state(api, opt, torch.Generator().manual_seed(seed),
                               device=CPU)


def _fail_once_at(step_no):
    boom = {"armed": True}

    def injector(s):
        if s == step_no and boom["armed"]:
            boom["armed"] = False
            raise NodeFailure("simulated pod loss")
    return injector


def _same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_loss_decreases(setup):
    api, opt, step, data = setup
    res = run(step, _init(api, opt, 0), data.batch, num_steps=60, device=CPU)
    first = np.mean([m["loss"] for m in res.metrics_history[:5]])
    last = np.mean([m["loss"] for m in res.metrics_history[-5:]])
    assert last < first - 0.3, f"no learning: {first} -> {last}"
    assert set(res.metrics_history[0]) >= {"loss", "lr", "grad_norm",
                                           "step", "wall_s", "straggler"}


def test_checkpoint_restart_is_bit_identical(setup, tmp_path):
    api, opt, step, data = setup
    init = _init(api, opt, 1)
    res_a = run(step, init, data.batch, num_steps=12, device=CPU)
    res_b = run(step, init, data.batch, num_steps=12,
                ckpt_dir=str(tmp_path / "ck"), ckpt_every=4,
                failure_injector=_fail_once_at(9), device=CPU)
    assert res_b.restarts == 1
    assert trajectory_diff(res_a.metrics_history, res_b.metrics_history,
                           keys=("loss", "grad_norm")) == []
    assert _same_state(res_a.state, res_b.state)
    assert int(res_a.state["step"]) == int(res_b.state["step"]) == 12
    assert res_b.ckpt_saves == 4 and res_b.restore_splits[0]["step"] == 8


def test_restore_via_state_policy_matches_default(setup, tmp_path):
    """Restoring through the compiled state program (params arena + delta
    opt state + marshalled metadata, one synchronize) resumes the same
    trajectory as the leaf-by-leaf restore; the staged params are views of
    the program's retained buckets, and the steps after the restore write
    none of them."""
    api, opt, step, data = setup
    init = _init(api, opt, 4)
    res_a = run(step, init, data.batch, num_steps=12, device=CPU)
    res_b = run(step, init, data.batch, num_steps=12,
                ckpt_dir=str(tmp_path / "ckp"), ckpt_every=4,
                failure_injector=_fail_once_at(9),
                state_policy=state_transfer_policy(), device=CPU)
    assert res_b.restarts == 1
    assert trajectory_diff(res_a.metrics_history, res_b.metrics_history) == []
    assert _same_state(res_a.state, res_b.state)
    split = res_b.restore_splits[0]
    assert split["policy"] == str(state_transfer_policy())
    assert all(split[k] >= 0.0 for k in ("load_s", "reshard_s", "h2d_s"))


def test_run_phase_mesh_shrink_reshards_instead_of_dying(setup, tmp_path):
    """A mesh shrink observed while running re-derives the policy and
    re-places the state; the restore after it compiles for the live mesh;
    the trajectory is unchanged."""
    api, opt, step, data = setup
    init = _init(api, opt, 7)
    res_ref = run(step, init, data.batch, num_steps=12, device=CPU)
    mesh = {"size": 2}

    def data_fn(s):
        if s >= 6:
            mesh["size"] = 1         # the controller reports the shrink
        return data.batch(s)

    res = run(step, init, data_fn, num_steps=12,
              ckpt_dir=str(tmp_path / "ckm"), ckpt_every=4,
              failure_injector=_fail_once_at(9),
              state_policy=state_transfer_policy(2),
              mesh_size=lambda: mesh["size"], device=CPU)
    assert res.restarts == 1 and res.policy_reshards == 1
    run_entries = [sp for sp in res.restore_splits if sp["phase"] == "run"]
    assert len(run_entries) == 1 and run_entries[0]["resharded"]
    assert "dp2" not in run_entries[0]["policy"]
    restores = [sp for sp in res.restore_splits if sp["phase"] == "restore"]
    assert restores and not any(sp["resharded"] for sp in restores)
    assert trajectory_diff(res_ref.metrics_history, res.metrics_history) == []
    assert int(res.state["step"]) == 12


def test_stale_policy_for_oversized_mesh_is_recovered(setup, tmp_path):
    api, opt, step, data = setup
    init = _init(api, opt, 4)
    ref = run(step, init, data.batch, num_steps=12, device=CPU)
    res = run(step, init, data.batch, num_steps=12,
              ckpt_dir=str(tmp_path / "ck"), ckpt_every=4,
              failure_injector=_fail_once_at(9),
              state_policy=state_transfer_policy(2), mesh_size=2, device=CPU)
    assert res.restarts == 1 and res.policy_reshards >= 1
    assert not trajectory_diff(ref.metrics_history, res.metrics_history)


def test_torn_restore_h2d_then_clean_restart(setup, tmp_path):
    api, opt, step, data = setup
    init = _init(api, opt, 5)
    ref = run(step, init, data.batch, num_steps=12, device=CPU)
    kw = dict(ckpt_dir=str(tmp_path / "ck"), ckpt_every=4,
              state_policy=state_transfer_policy(), device=CPU)
    run(step, init, data.batch, num_steps=8, **kw)
    with faults.injected("restore.h2d"):
        with pytest.raises(InjectedFault):
            run(step, init, data.batch, num_steps=12, **kw)
    res = run(step, init, data.batch, num_steps=12, **kw)
    assert res.restore_splits and res.restore_splits[0]["step"] == 8
    assert not trajectory_diff(ref.metrics_history, res.metrics_history)
    assert int(res.state["step"]) == 12


def test_too_many_failures_raises(setup, tmp_path):
    api, opt, step, data = setup

    def always_fail(s):
        raise NodeFailure("hard down")

    with pytest.raises(NodeFailure):
        run(step, _init(api, opt, 0), data.batch, num_steps=5,
            ckpt_dir=str(tmp_path / "ck2"), failure_injector=always_fail,
            max_restarts=2, device=CPU)


def test_restore_error_names_schema_mismatch(setup, tmp_path):
    """A checkpoint of a foreign state schema (here written by the
    reference) is named as such, with what it holds."""
    api, opt, step, data = setup
    foreign = {"weights": np.zeros(4, np.float32), "count": np.int32(3)}
    r_ckpt.save(foreign, str(tmp_path / "ck"), 8)
    with pytest.raises(RestoreError, match="schema mismatch") as ei:
        run(step, _init(api, opt, 0), data.batch, num_steps=12,
            ckpt_dir=str(tmp_path / "ck"), device=CPU)
    assert "count" in str(ei.value) and "weights" in str(ei.value)


def test_the_loop_needs_a_card_unless_asked_for_the_cpu(setup):
    api, opt, step, data = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(NoCudaDeviceError):
        run(step, _init(api, opt, 0), data.batch, num_steps=1)


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(window=50, k_sigma=3.0)
    for i in range(20):
        wd.observe(i, 0.010 + 0.0001 * (i % 3))
    assert wd.observe(20, 0.200) is True
    assert wd.observe(21, 0.010) is False
    assert wd.flagged == [20]


# -------------------------------------------------------- elastic restart

def test_elastic_restart_bit_identical(setup, tmp_path):
    """n = 2 (the stale policy's mesh) down to m = 1, the one device
    here: the survivor re-derives the policy and resumes bit for bit."""
    api, opt, step, data = setup
    init = _init(api, opt, 7)
    ref = run(step, init, data.batch, num_steps=12, device=CPU)
    res = run_elastic(step, init, data.batch, num_steps=12,
                      ckpt_dir=str(tmp_path / "ck"), crash_step=9,
                      n_devices=2, m_devices=1, ckpt_every=4,
                      policy_fn=state_transfer_policy, device=CPU)
    assert res.restored_step == 8
    assert res.n_devices == 2 and res.m_devices == 1
    assert trajectory_diff(ref.metrics_history,
                           res.result.metrics_history) == []
    assert [int(r["step"]) for r in res.result.metrics_history] == \
        list(range(8, 12))
    assert _same_state(ref.state, res.result.state)
    split = res.restore_split
    assert split["step"] == 8 and split["resharded"] is True
    assert "dp2" not in split["policy"]
    assert res.result.policy_reshards >= 1


def test_run_elastic_rejects_uncheckpointable_crash():
    with pytest.raises(ValueError, match="nothing durable"):
        run_elastic(None, None, None, 12, ckpt_dir="/nonexistent",
                    crash_step=3, n_devices=2, m_devices=1, ckpt_every=4)


def test_trajectory_diff_reports_mismatches():
    ref = [{"step": 0, "loss": 1.0}, {"step": 1, "loss": 0.5}]
    assert trajectory_diff(ref, [{"step": 1, "loss": 0.5}]) == []
    bad = trajectory_diff(ref, [{"step": 1, "loss": 0.5000001},
                                {"step": 2, "loss": 0.1}])
    assert len(bad) == 2
    assert "step 1" in bad[0] and "not in the reference" in bad[1]


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("seed,rank,world", [(0, 0, 1), (3, 0, 2), (3, 1, 2),
                                             (11, 3, 4)])
def test_synthetic_lm_is_bit_equal_to_the_reference(seed, rank, world):
    a = SyntheticLM(257, 16, 8, seed=seed, rank=rank, world=world)
    b = RSyntheticLM(257, 16, 8, seed=seed, rank=rank, world=world)
    for step in (0, 1, 7, 12345):
        pa, pb = a.batch(step), b.batch(step)
        assert sorted(pa) == sorted(pb)
        for k in pb:
            assert pa[k].dtype == pb[k].dtype
            np.testing.assert_array_equal(pa[k], pb[k])


def test_data_is_deterministic_and_rank_sharded():
    a = SyntheticLM(100, 16, 8, seed=3, rank=0, world=2)
    b = SyntheticLM(100, 16, 8, seed=3, rank=1, world=2)
    np.testing.assert_array_equal(a.batch(5)["tokens"],
                                  SyntheticLM(100, 16, 8, seed=3, rank=0,
                                              world=2).batch(5)["tokens"])
    assert not np.array_equal(a.batch(5)["tokens"], b.batch(5)["tokens"])
    t = a.batch(0)
    np.testing.assert_array_equal(t["labels"], (31 * t["tokens"] + 7) % 100)
    with pytest.raises(ValueError, match="divisible"):
        SyntheticLM(100, 16, 7, world=2)


def test_prefetcher_yields_in_order():
    pf = Prefetcher(iter([{"i": np.asarray(i)} for i in range(10)]),
                    prefetch=3)
    assert [int(b["i"]) for b in pf] == list(range(10))


def test_prefetcher_propagates_errors():
    def gen():
        yield {"i": 0}
        raise ValueError("source died")
    pf = Prefetcher(gen())
    next(pf)
    with pytest.raises(ValueError):
        for _ in pf:
            pass


# ------------------------------------------------------------------- CLI

def test_cli_smoke_on_the_cpu(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train as cli

    res = cli.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    "--steps", "6", "--batch", "2", "--seq", "16",
                    "--log-every", "0", "--ckpt-dir", str(tmp_path / "ck"),
                    "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "done: loss" in out and "6 steps" in out
    assert int(res.state["step"]) == 6
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000003", "step_00000006"]
    seen = {}
    real_run = cli.loop_mod.run
    real_step = cli.make_dp_train_step

    def spy_run(*a, **kw):
        seen["state_policy"] = kw["state_policy"]
        return real_run(*a, **kw)

    def spy_step(api, opt, lr, mesh, **kw):
        seen["mesh"] = mesh
        return real_step(api, opt, lr, mesh, **kw)

    monkeypatch.setattr(cli.loop_mod, "run", spy_run)
    monkeypatch.setattr(cli, "make_dp_train_step", spy_step)
    res = cli.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch",
                    "2", "--seq", "16", "--log-every", "0", "--dp-shardmap",
                    "--compress"])
    assert int(res.state["step"]) == 3
    # the dp path: a (visible devices, 1) mesh, restores without a policy
    assert seen["state_policy"] is None
    assert seen["mesh"].shape == {"data": 1, "model": 1}
    assert seen["mesh"].positions == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert cli.visible_positions(torch.device("cuda", 0)) == 3
    assert cli.visible_positions(torch.device("cpu")) == 1
    cli.main(["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
              "--seq", "16", "--log-every", "0"])
    assert seen["state_policy"] is not None    # the plain path keeps it
    # the production mesh needs its 256 cards: fewer is the stale-mesh
    # error (tests/test_torch_sharded_train.py drives it on CPU positions)
    from repro_torch.core import UnsupportedSpecError
    with pytest.raises(UnsupportedSpecError, match="dp256"):
        cli.main(["--smoke", "--production-mesh"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "moonshot-v1-16b-a3b", "phi-3-vision-4.2b"])
def test_cli_trains_the_other_families_on_the_cpu(arch, capsys):
    """The ssm, hybrid, MoE and vlm smoke models take CLI steps (the vlm on
    text alone: the CLI's data has no patches); the loss stays finite."""
    from repro_torch.launch import train as cli

    res = cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "3", "--batch", "2", "--seq", "16", "--log-every", "0"])
    assert "3 steps" in capsys.readouterr().out
    assert int(res.state["step"]) == 3
    losses = [m["loss"] for m in res.metrics_history]
    assert len(losses) == 3 and all(np.isfinite(losses))
