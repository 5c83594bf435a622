"""Fleet sharding of the port (``repro_torch.core.shard``, the sharded tick,
``run``/``run_batch``/``sweep``/``solo``/``BBCluster`` on a mesh of ranks)
against the port's unsharded runs and the JAX reference's.

In process: the counterparts of ``tests/test_shard.py``'s spec resolution,
config validation and tick-path tests (the port's message names its
launcher where the reference's names ``XLA_FLAGS``).  Then one world of 4
gloo CPU ranks (``repro_torch.launch.mesh.spawn``; the ranks run
``tests/_torch_shard_ranks.py`` and import no ``jax``) runs the reference's
job lists sharded, while this process runs them unsharded on the port and on
the JAX package: every ``EngineState`` field of the sharded runs equals the
unsharded run's bit for bit, every rank returns the same result, and themis
and adaptbf equal the reference counter for counter.
"""
import concurrent.futures

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_shard_ranks as ranks
from repro.api import Experiment as RefExperiment
from repro.core import engine as ref_engine
from repro.core.policy import Policy as RefPolicy
from repro_torch.bb.service import BBCluster
from repro_torch.core.engine import EngineConfig, init_state, resolve_tick_impl
from repro_torch.core.scheduler import available_schedulers, get_scheduler
from repro_torch.core.shard import ShardSpec, resolve_shard, state_specs
from repro_torch.launch.mesh import spawn

QUICK = ranks.QUICK
SCHEDULERS = available_schedulers()


class TestResolveShard:
    def test_default_is_unsharded(self):
        assert resolve_shard(EngineConfig(device="cpu")) is None

    def test_shard_servers_sugar(self):
        spec = ShardSpec(n_sweep=1, n_servers=2)
        assert spec.n_devices == 2
        assert spec.slab(8) == 4

    def test_mesh_shape_one_tuple_means_servers(self):
        with pytest.raises(ValueError, match="devices"):
            EngineConfig(n_servers=4, mesh_shape=(4,), device="cpu")

    def test_error_names_the_launcher(self):
        with pytest.raises(ValueError, match="launch.mesh.spawn"):
            EngineConfig(n_servers=4, shard_servers=4, device="cpu")

    def test_indivisible_servers_rejected(self):
        with pytest.raises(ValueError, match="divisible"):
            EngineConfig(n_servers=3, shard_servers=2, device="cpu")

    def test_conflicting_knobs_rejected(self):
        with pytest.raises(ValueError, match="conflicts"):
            EngineConfig(n_servers=4, shard_servers=2, mesh_shape=(1, 4),
                         device="cpu")

    def test_bad_mesh_rank_rejected(self):
        with pytest.raises(ValueError, match="mesh_shape"):
            EngineConfig(mesh_shape=(2, 2, 2), device="cpu")

    @pytest.mark.parametrize("knobs, match", [
        (dict(shard_servers=0), "shard_servers must be >= 1"),
        (dict(mesh_shape=(0, 2)), "mesh axes must be >= 1")])
    def test_axes_below_one_rejected(self, knobs, match):
        with pytest.raises(ValueError, match=match):
            EngineConfig(n_servers=4, device="cpu", **knobs)

    def test_state_specs_slab_vs_replicated(self):
        st = init_state(EngineConfig(n_servers=4, device="cpu"), n_bins=1)
        specs = state_specs(st, ShardSpec(n_sweep=1, n_servers=2))
        assert specs.qcount == (None, "servers")
        assert specs.arr_time == (None, "servers")
        assert specs.aux == (None, "servers")
        assert specs.t == ()
        assert specs.bytes_bin == (None,)
        specs2 = state_specs(st, ShardSpec(n_sweep=2, n_servers=2),
                             lead=("sweep",))
        assert specs2.qcount == ("sweep", "servers")
        assert specs2.completed == ("sweep",)


class TestConfigValidation:
    @pytest.mark.parametrize("field", ["n_servers", "max_jobs", "n_workers"])
    def test_zero_geometry_fails_at_config_time(self, field):
        with pytest.raises(ValueError, match=field):
            EngineConfig(**{field: 0}, device="cpu")

    def test_negative_and_non_int_fail(self):
        with pytest.raises(ValueError, match="n_servers"):
            EngineConfig(n_servers=-1, device="cpu")
        with pytest.raises(ValueError, match="n_servers"):
            EngineConfig(n_servers=2.0, device="cpu")

    def test_worker_bw_ideal_fabric_is_even_split(self):
        cfg = EngineConfig(n_servers=8, n_workers=4, server_bw=20e9,
                           device="cpu")
        assert cfg.worker_bw == pytest.approx(5e9)

    def test_worker_bw_fabric_derate(self):
        cfg = EngineConfig(n_servers=8, n_workers=4, server_bw=20e9,
                           fabric_exponent=0.08, device="cpu")
        assert cfg.worker_bw == pytest.approx(5e9 * 8 ** -0.08)


class TestMixedDeviceSafety:
    def test_sharded_config_forces_scan(self, recwarn):
        for name in SCHEDULERS:
            cfg = EngineConfig.__new__(EngineConfig)
            object.__setattr__(cfg, "tick_impl", "fused")
            object.__setattr__(cfg, "mesh_shape", (1, 2))
            object.__setattr__(cfg, "shard_servers", 1)
            object.__setattr__(cfg, "scheduler", name)
            assert resolve_tick_impl(cfg, get_scheduler(name)) == "scan"
        assert len(recwarn) == 0

    def test_unsharded_resolution_unchanged(self):
        cfg = EngineConfig(scheduler="themis", tick_impl="fused", device="cpu")
        assert resolve_tick_impl(cfg, get_scheduler("themis")) == "fused"


class TestLauncher:
    @pytest.mark.parametrize("kw", [dict(n_ranks=0), dict(n_ranks=1,
                                                          device="tpu")])
    def test_rejects_bad_arguments(self, kw):
        with pytest.raises(ValueError):
            spawn(ranks.fail, **kw)

    def test_a_failing_rank_raises_with_its_traceback(self):
        with pytest.raises(mp.ProcessRaisedException,
                           match="rank failed on purpose"):
            spawn(ranks.fail, 1)


def reference_runs() -> dict:
    """The JAX package, unsharded: themis and adaptbf runs of the job list,
    and the adaptbf sweep."""
    out = {}
    for name in QUICK:
        cfg = ref_engine.EngineConfig(
            scheduler=name, policy=RefPolicy.parse("user-fair"),
            **ranks.GEOMETRY)
        wl, table = ref_engine.make_workload(cfg, ranks.JOBS)
        st = ref_engine.run(cfg, wl, table, ranks.SECONDS)["state"]
        out[name] = {f: np.asarray(getattr(st, f)) for f in COUNTERS}
    ex = RefExperiment("user-fair", "adaptbf", n_servers=4, n_workers=4,
                       seed=5)
    ex.add_job(user=0, procs=30, req_mb=8, think_s=0.001)
    ex.add_job(user=1, procs=12, req_mb=4, think_s=0.004)
    out["sweep"] = ranks.sweep_arrays(ex.sweep(
        ranks.SWEEP_GRID, ranks.SECONDS, seeds=ranks.SWEEP_SEEDS))
    return out


COUNTERS = ("qcount", "head", "wheel", "known", "issued", "completed",
            "idle_worker_ticks", "dropped")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's sharded runs, started first; meanwhile this process runs
    the unsharded port and the reference."""
    workspace = tmp_path_factory.mktemp("shard_workspace")
    threads = torch.get_num_threads()
    # The ranks run one thread each; so does this process meanwhile (the
    # tensors are tiny, and idle workers would compete with the ranks).
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            world = pool.submit(spawn, ranks.world_jobs, 4,
                                args=(SCHEDULERS, QUICK, str(workspace)))
            port = ranks.jobs(SCHEDULERS, QUICK)
            ref = reference_runs()
            return dict(world=world.result(), port=port, ref=ref,
                        workspace=workspace)
    finally:
        torch.set_num_threads(threads)


def assert_states_equal(got: dict, want: dict, tag: str) -> None:
    assert sorted(got) == sorted(want), tag
    for f, a in want.items():
        np.testing.assert_array_equal(got[f], a, err_msg=f"{tag}: {f}")


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_run_equals_unsharded_bit_for_bit(runs, scheduler):
    got = runs["world"]["results"]["run"][scheduler]
    assert_states_equal(got, runs["port"]["run"][scheduler],
                        f"{scheduler}/run x4")
    assert got["completed"].sum() > 0


@pytest.mark.parametrize("scheduler", QUICK)
def test_run_batch_on_a_2x2_mesh_equals_unsharded(runs, scheduler):
    assert_states_equal(runs["world"]["results"]["run_batch"][scheduler],
                        runs["port"]["run_batch"][scheduler],
                        f"{scheduler}/run_batch (2, 2)")


def test_run_batch_on_a_sweep_only_mesh_equals_unsharded(runs):
    world = runs["world"]["results"]
    assert_states_equal(world["sweep_only"], runs["port"]["sweep_only"],
                        "fifo/run_batch (4, 1)")
    # No gather a tick: the lanes' gather, the Poisson check, the broadcast.
    assert world["collectives"]["sweep_only"] == 3


def test_sweep_on_a_2x2_mesh_through_a_workspace(runs):
    got, want = runs["world"]["results"]["sweep"], runs["port"]["sweep"]
    assert_states_equal(got, want, "sweep (2, 2)")
    assert not np.array_equal(want["gbps"][0], want["gbps"][3])
    # Rank 0 alone wrote: one journal line per grid point.
    journals = list((runs["workspace"] / "campaigns").glob("*.jsonl"))
    assert len(journals) == 1
    assert len(journals[0].read_text().splitlines()) == 4


def test_solo_with_ranks_outside_the_mesh(runs):
    got, want = runs["world"]["results"]["solo"], runs["port"]["solo"]
    for f in ("gbps", "issued", "completed"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert_states_equal(got["state"], want["state"], "solo x2 of 4 ranks")


def test_service_drain_ignores_shard_knobs(runs):
    assert runs["world"]["results"]["service"] == runs["port"]["service"]


def test_service_refuses_a_mesh_without_ranks():
    with pytest.raises(ValueError, match="ranks"):
        BBCluster(n_servers=2, shard_servers=2, device="cpu")


def test_every_rank_returns_the_same_result_without_jax(runs):
    digests = runs["world"]["digests"]
    assert len(digests) == 4
    assert len({d for d, _ in digests}) == 1
    assert not any(jax for _, jax in digests)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_one_collective_per_tick(runs, scheduler):
    n, ticks = runs["world"]["results"]["collectives"][scheduler]
    # One gather per tick, then the slabs' gather, the Poisson check's
    # reduction and rank 0's broadcast.
    assert n == ticks + 3


@pytest.mark.parametrize("scheduler", QUICK)
def test_sharded_run_matches_reference_counters(runs, scheduler):
    got = runs["world"]["results"]["run"][scheduler]
    for f, want in runs["ref"][scheduler].items():
        np.testing.assert_array_equal(got[f], want,
                                      err_msg=f"{scheduler}: {f}")


def test_sharded_sweep_matches_reference(runs):
    assert_states_equal(runs["world"]["results"]["sweep"], runs["ref"]["sweep"],
                        "sweep vs reference")
