"""PyTorch port, the training loop's host side on the CPU: the data
pipeline against the JAX package's (bit for bit), checkpoints (round
trip, the reference's on-disk layout, atomic commit, the async manager's
garbage collection), a restart after an injected failure that replays
the uninterrupted run's losses bit for bit, the straggler detector, and
the training CLI."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as JCK  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokenPipeline as JPipe  # noqa: E402
from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: E402
                                         latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline  # noqa: E402,E501
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.fault import FaultInjector  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, train_loop  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402
from repro_torch.train.straggler import StragglerDetector  # noqa: E402


@pytest.mark.parametrize("seed,step,shard,num_shards",
                         [(0, 0, 0, 1), (7, 3, 1, 2), (3, 11, 3, 4)])
def test_data_batches_bit_identical_to_reference(seed, step, shard,
                                                 num_shards):
    kw = dict(vocab=1000, seq_len=16, global_batch=8, seed=seed)
    got = SyntheticTokenPipeline(DataConfig(**kw)).reshard(
        shard, num_shards).batch(step)
    want = JPipe(JDataConfig(**kw)).reshard(shard, num_shards).batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    assert (got["labels"][:, :-1] == got["tokens"][:, 1:]).all()


def _state():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.linspace(-2, 2, 4).to(torch.bfloat16)},
            "step": torch.tensor(5, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_reference_layout(tmp_path):
    """A port checkpoint restores in place into the port's structure, and
    the reference's ``restore_checkpoint`` reads the same directory into
    its own tree (bf16 stored as uint16 bits, leaves in tree order)."""
    state = _state()
    save_checkpoint(str(tmp_path), 5, state)
    like = {"a": torch.zeros((2, 3), dtype=torch.int32),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    restored, step = restore_checkpoint(str(tmp_path), like)
    assert step == 5 and restored is like
    for (a, b) in ((like["a"], state["a"]), (like["b"]["c"], state["b"]["c"]),
                   (like["step"], state["step"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jlike = {"a": jnp.zeros((2, 3), jnp.int32),
             "b": {"c": jnp.zeros(4, jnp.bfloat16)},
             "step": jnp.zeros((), jnp.int32)}
    jstate, jstep = JCK.restore_checkpoint(str(tmp_path), jlike)
    assert jstep == 5
    assert np.array_equal(np.asarray(jstate["a"]), state["a"].numpy())
    assert str(jstate["b"]["c"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(jstate["b"]["c"]).view(np.uint16),
                          state["b"]["c"].view(torch.int16).numpy().view(
                              np.uint16))
    with pytest.raises(ValueError):                  # structure changed
        restore_checkpoint(str(tmp_path), {"a": like["a"]})


def test_checkpoint_of_a_train_state(tmp_path):
    """A model's leaves follow its ``state_dict``; the optimizer's follow
    them; a restore into a fresh state gives back every tensor."""
    cfg = get_config("mamba2-780m").reduced()
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    state = init_train_state(cfg, model, AdamWConfig(moments_dtype="int8"))
    state["step"] += 3
    final = save_checkpoint(str(tmp_path), 3, state)
    with open(os.path.join(final, "manifest.json")) as fh:
        manifest = json.load(fh)
    names = list(model.state_dict())
    assert manifest["n_leaves"] == len(names) * 5 + 2
    assert manifest["index"][0]["dtype"] == "bfloat16"
    fresh = init_train_state(cfg, Model(cfg, device="cpu", generator=None),
                             AdamWConfig(moments_dtype="int8"))
    restore_checkpoint(str(tmp_path), fresh)
    for (n, a), b in zip(model.state_dict().items(),
                         fresh["params"].state_dict().values()):
        assert torch.equal(a, b), n
    assert int(fresh["step"]) == 3


def test_checkpoint_atomic_commit(tmp_path):
    """A stale ``.tmp`` directory is never a checkpoint."""
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "missing")) is None
    save_checkpoint(str(tmp_path), 3, {"x": torch.zeros(2)})
    assert latest_step(str(tmp_path)) == 3
    restored, step = restore_checkpoint(str(tmp_path / "empty"),
                                        {"x": torch.ones(2)})
    assert step is None and torch.equal(restored["x"], torch.ones(2))


def test_checkpoint_manager_async_and_gc(tmp_path):
    """Saves run on a thread from a snapshot (a later in-place change does
    not reach the file), and only the last ``keep`` survive."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    x = torch.zeros(3)
    for s in (1, 2, 3, 4):
        x.fill_(s)
        mgr.save_async(s, {"x": x})
        x.fill_(-1)
    mgr.wait()
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    like = {"x": torch.zeros(3)}
    _, step = mgr.restore_latest(like)
    assert step == 4 and torch.equal(like["x"], torch.full((3,), 4.0))


def test_restart_replays_the_uninterrupted_run_bit_for_bit(tmp_path):
    """A failure injected at step 6 restores the checkpoint of step 4 and
    replays steps 4-11: the losses of the replay equal the uninterrupted
    run's bit for bit (counter-mode data, a deterministic step)."""
    cfg = get_config("starcoder2-15b").reduced()

    def run(ckpt_dir, inj=None):
        loop = TrainLoopConfig(steps=12, ckpt_every=4, global_batch=2,
                               seq_len=16, ckpt_dir=ckpt_dir)
        return train_loop(cfg, loop, fault_injector=inj, device="cpu")

    clean = run(str(tmp_path / "a"))
    faulty = run(str(tmp_path / "b"), FaultInjector(fail_at={6}))
    assert clean["restarts"] == 0 and faulty["restarts"] == 1
    assert faulty["steps_run"] == clean["steps_run"] == 12
    assert faulty["losses"] == clean["losses"][:6] + clean["losses"][4:]
    assert np.isfinite(clean["losses"]).all()
    for a, b in zip(clean["state"]["params"].parameters(),
                    faulty["state"]["params"].parameters()):
        assert torch.equal(a, b)


def test_straggler_detector_flags_and_evicts():
    t = [0.0]
    det = StragglerDetector(threshold=2.0, warmup_steps=2, trip_limit=2,
                            clock=lambda: t[0])
    events = []
    for i, d in enumerate([1.0, 1.0, 1.0, 1.0, 5.0, 5.0, 1.0]):
        det.step_start()
        t[0] += d
        ev = det.step_end(i)
        if ev:
            events.append(ev)
        if i == 5:
            assert det.should_evict
    assert len(events) == 2 and events[0].ratio > 2.0
    assert not det.should_evict   # a normal step reset the trip counter


def test_train_cli_on_the_cpu(tmp_path, capsys):
    """``--smoke`` is always on, as in the reference: the reduced config."""
    train_cli.main(["--arch", "mamba2-780m", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "mamba2-780m-smoke" and out["device"] == "cpu"
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert latest_step(str(tmp_path)) == 2
