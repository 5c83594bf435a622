"""The port's data pipeline, checkpoints, trainer and train CLI against the
JAX package, on the CPU.

Batches are numpy ``int32`` on both sides and must be equal bit for bit,
through the port's burst buffer too.  Checkpoints round-trip bit for bit,
locally and through the burst buffer, and name their leaves as the
reference's manager does.  A restart resumes bit for bit.  The trainer's
loss history from the reference's state is held to the reference
``Trainer``'s within the tolerance stated there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as RC
from repro.configs.base import get_config as ref_get_config
from repro.data import pipeline as RD
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro.train import trainer as RTR
from repro_torch.api import Experiment
from repro_torch.ckpt import manager as TC
from repro_torch.configs import base as tcfg
from repro_torch.core import convert
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as launch
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT
from repro_torch.train import trainer as TTR

DCFG = dict(vocab=512, seq_len=16, batch_size=4, shard_tokens=1024,
            n_shards=4, seed=7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def small_cfg(**kw):
    return dataclasses.replace(tcfg.get_config("h2o-danube-1.8b",
                                               reduced=True),
                               loss_chunk=16, **kw)


def bb_client(n_servers=2):
    """A client of the port's burst buffer on the CPU, as the quickstart
    stands it up (size-fair, one declared job)."""
    exp = Experiment(policy="size-fair", n_servers=n_servers, device="cpu")
    return exp.add_job(user=0, size=4, req_mb=8).serve().client(0)


def batches(loader, n):
    return [loader.next_batch() for _ in range(n)]


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


# -- data -----------------------------------------------------------------------

def test_loader_equals_reference_with_resume_and_ranks():
    """Twenty batches (past two shard swaps and an epoch), a loader resumed
    from the state after seven, and rank 1 of 2: each equal to the
    reference's bit for bit."""
    same_batches(batches(TD.DataLoader(TD.DataConfig(**DCFG)), 20),
                 batches(RD.DataLoader(RD.DataConfig(**DCFG)), 20))
    port, ref = (mod.DataLoader(mod.DataConfig(**DCFG)) for mod in (TD, RD))
    batches(port, 7)
    batches(ref, 7)
    assert port.state_dict() == ref.state_dict()
    resumed = TD.DataLoader(TD.DataConfig(**DCFG))
    resumed.load_state(port.state_dict())
    same_batches(batches(resumed, 8), batches(ref, 8))
    same_batches(batches(TD.DataLoader(TD.DataConfig(**DCFG), rank=1,
                                       world=2), 10),
                 batches(RD.DataLoader(RD.DataConfig(**DCFG), rank=1,
                                       world=2), 10))


def test_loader_through_the_burst_buffer():
    """Shards written through the port's BB and read back by the loader:
    the reference's batches (generated on the fly) bit for bit, across an
    epoch boundary, and the BB servers did the I/O."""
    client = bb_client()
    dcfg = TD.DataConfig(**DCFG)
    writer = TD.ShardWriter(dcfg, client=client)
    writer.write_epoch(0)
    writer.write_epoch(1)
    same_batches(batches(TD.DataLoader(dcfg, client=client), 20),
                 batches(RD.DataLoader(RD.DataConfig(**DCFG)), 20))
    assert sum(len(s.processed) for s in client.cluster.servers) > 0


# -- checkpoints ------------------------------------------------------------------

def payload(cfg, seed=0):
    state = TT.init_state(cfg, seed=seed, device="cpu")
    return {"state": state, "loader": {"state": np.asarray([0, 1, 2],
                                                           np.int64)}}


def equal_trees(a, b):
    la, lb = TC._flatten(a), TC._flatten(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, name
            assert torch.equal(x, y), name
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("backend", ["local", "bb"])
def test_checkpoint_round_trip(tmp_path, backend):
    """bf16 and float32 leaves, the int32 step and the loader's int64
    state restore bit for bit into a like-tree, keeping requires_grad;
    ``keep`` drops the oldest manifests."""
    cfg = small_cfg(param_dtype="bfloat16")
    client = bb_client() if backend == "bb" else None
    root = "/ckpt" if client else str(tmp_path / "ckpt")
    mgr = TC.CheckpointManager(root, client=client, keep=2)
    saved = payload(cfg, seed=1)
    for step in (2, 4, 6):
        mgr.save(step, saved)
    assert mgr.latest_step() == 6 and sorted(mgr._steps()) == [4, 6]
    restored, step = mgr.restore(payload(cfg, seed=2))
    assert step == 6
    equal_trees(restored, saved)
    params = restored["state"].params
    assert isinstance(params, TM.ModelParams)
    assert all(p.requires_grad for p in params.parameters())
    assert params["embed"]["table"].dtype == torch.bfloat16


def test_checkpoint_corruption_is_detected(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(6.0)})
    leaf = next(p for p in (tmp_path / "step_00000001.tmp").iterdir())
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(IOError, match="checksum mismatch for w"):
        mgr.restore({"w": torch.zeros(6)})
    with pytest.raises(FileNotFoundError):
        TC.CheckpointManager(str(tmp_path / "empty")).restore({})


def test_checkpoint_leaf_names_are_the_references():
    """The same payload structure (a TrainState with the optimizer state,
    the loader's state) gives the reference manager's leaf names."""
    cfg = small_cfg()
    port = payload(cfg)
    np_state = RT.TrainState(params=convert.tree_to_numpy(port["state"]
                                                           .params),
                             opt=RO.init(convert.tree_to_numpy(
                                 port["state"].params)))
    ref = {"state": np_state, "loader": port["loader"]}
    assert [n for n, _ in TC._flatten(port)] == [n for n, _ in
                                                 RC._flatten(ref)]


# -- the trainer ---------------------------------------------------------------------

def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(3)
    times = rng.gamma(4.0, 0.01, 200)
    times[[17, 90, 91, 150]] *= 8
    port, ref = (mod.StragglerDetector(3.0, 0.9) for mod in (TTR, RTR))
    flags = [(port.observe(i, t), ref.observe(i, t))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert port.events == ref.events and len(port.events) >= 4
    assert port.mean == ref.mean


def make_trainer(cfg, client, root, steps):
    dcfg = TD.DataConfig(vocab=cfg.vocab, seq_len=16, batch_size=2,
                         shard_tokens=1 << 12, n_shards=2)
    return TTR.Trainer(cfg, TO.OptConfig(lr=1e-3, warmup_steps=3,
                                         total_steps=steps),
                       TTR.TrainerConfig(total_steps=steps, ckpt_every=4),
                       TD.DataLoader(dcfg, client=client),
                       ckpt=TC.CheckpointManager(root, client=client),
                       bb_client=client, device="cpu")


def test_restart_through_the_burst_buffer_is_bit_identical():
    """The quickstart's set-up on the CPU: data shards and checkpoints
    through a size-fair 2-server BB, 12 steps, a checkpoint every 4, a
    failure injected at step 6: run_with_restarts resumes from step 4 and
    every loss from there equals an uninterrupted run's bit for bit."""
    cfg = small_cfg()
    client = bb_client()
    dcfg = TD.DataConfig(vocab=cfg.vocab, seq_len=16, batch_size=2,
                         shard_tokens=1 << 12, n_shards=2)
    TD.ShardWriter(dcfg, client=client).write_epoch(0)
    TD.ShardWriter(dcfg, client=client).write_epoch(1)
    whole = make_trainer(cfg, client, "/ckpt_a", 12)
    whole.init_or_restore()
    want = whole.run()
    calls = []
    got = TTR.run_with_restarts(
        lambda: calls.append(1) or make_trainer(cfg, client, "/ckpt_b", 12),
        die_at=6)
    assert len(calls) == 2
    assert [h["step"] for h in got] == list(range(4, 12))
    assert [h["loss"] for h in got] == [h["loss"] for h in want[4:]]
    assert all(np.isfinite(h["loss"]) for h in want)


def test_loss_history_matches_reference_trainer():
    """Five steps of the port's Trainer and the reference's from the same
    parameters and batch stream: every loss to rel 1e-5 (the parameters
    agree to float32 rounding after each AdamW step)."""
    cfg = small_cfg()
    rcfg = dataclasses.replace(ref_get_config("h2o-danube-1.8b",
                                              reduced=True), loss_chunk=16)
    np_params = convert.tree_to_numpy(TM.init_params(cfg, 4, device="cpu"))
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    tcfg_ = dict(total_steps=5, ckpt_every=100)
    dcfg = dict(vocab=cfg.vocab, seq_len=32, batch_size=2,
                shard_tokens=1 << 12, n_shards=2)
    ref = RTR.Trainer(rcfg, RO.OptConfig(**ocfg),
                      RTR.TrainerConfig(**tcfg_),
                      RD.DataLoader(RD.DataConfig(**dcfg)))
    ref.state = RT.TrainState(params=jax.tree.map(jnp.asarray, np_params),
                              opt=RO.init(np_params))
    port = TTR.Trainer(cfg, TO.OptConfig(**ocfg), TTR.TrainerConfig(**tcfg_),
                       TD.DataLoader(TD.DataConfig(**dcfg)), device="cpu")
    port.init_or_restore()
    port.state = convert.train_state_from_numpy(ref.state, cfg)
    want, got = ref.run(), port.run()
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-5)


def test_train_cli_on_cpu(capsys):
    trainer = launch.main(["--device", "cpu", "--steps", "3", "--seq", "32",
                           "--batch", "2"])
    out = capsys.readouterr().out
    assert "final loss" in out and len(trainer.history) == 3
    assert trainer.device.type == "cpu"
