"""Policy chain, λ-sync and params schemas of the port against the JAX
reference, on the same numpy inputs.

The chain's row sums and Sinkhorn's column and row sums are taken in the
reference's order (XLA CPU's windows of 32, its fused multiply-adds and
flushed subnormals), so shares and segments equal the reference's bit for
bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import global_sync as ref_sync
from repro.core import job_table as ref_jt
from repro.core import params as ref_params
from repro.core import policy as ref_policy
from repro_torch.core import global_sync, params
from repro_torch.core.job_table import make_table
from repro_torch.core.policy import Policy, PolicyChain, compute_job_shares

NAMED = ("job-fair", "size-fair", "priority-fair", "user-fair", "group-fair",
         "user-then-job-fair", "user-then-size-fair", "group-then-user-fair",
         "group-then-size-fair", "group-user-size-fair")
J = 24


def random_jobs(seed, n_jobs=18):
    rng = np.random.default_rng(seed)
    return [dict(user=int(rng.integers(0, 5)), group=int(rng.integers(0, 3)),
                 size=int(rng.integers(1, 9)),
                 priority=float(rng.choice([0.5, 1.0, 2.0, 3.0])))
            for _ in range(n_jobs)]


def both_tables(jobs):
    return ref_jt.make_table(jobs, max_jobs=J), make_table(jobs, max_jobs=J)


@pytest.mark.parametrize("with_demand", (False, True))
@pytest.mark.parametrize("name", NAMED)
def test_compute_job_shares_matches_reference(name, with_demand):
    rt, tt = both_tables(random_jobs(NAMED.index(name)))
    demand = None
    if with_demand:
        demand = np.random.default_rng(7).random(J) < 0.6
    want = ref_policy.compute_job_shares_from_table(
        ref_policy.Policy.parse(name), rt,
        demand=None if demand is None else jnp.asarray(demand))
    got = compute_job_shares(
        Policy.parse(name), active=tt.active, user_id=tt.user_id,
        group_id=tt.group_id, size=tt.size, priority=tt.priority,
        demand=None if demand is None else torch.as_tensor(demand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_parse_errors_match_reference():
    with pytest.raises(ValueError, match="unknown policy"):
        Policy.parse("user-fiar")
    with pytest.raises(ValueError, match="baseline"):
        Policy.parse("fifo")
    assert Policy.parse("group:fair,user:size").levels[-1].entity == "job"


def test_paper_worked_examples():
    chain_shares = lambda name, jobs: compute_job_shares(
        Policy.parse(name), **{k: v for k, v in make_table(jobs, 8)._asdict()
                               .items() if k != "last_heartbeat"}).numpy()
    np.testing.assert_allclose(
        chain_shares("size-fair", [{"size": 16}, {"size": 8}, {"size": 8}])[:3],
        [0.5, 0.25, 0.25], atol=1e-6)
    np.testing.assert_allclose(
        chain_shares("user-fair", [{"user": 0}, {"user": 0}, {"user": 1}])[:3],
        [0.25, 0.25, 0.5], atol=1e-6)


def test_sinkhorn_fig5_fixed_point():
    """Paper Fig. 5: jobs 16:8:8, job 1 on both servers -> 0.5 on each."""
    support = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
    col = torch.tensor([0.5, 0.25, 0.25])
    a = global_sync.sinkhorn_balance(support, col)
    np.testing.assert_allclose(a.numpy(), [[0.5, 0.5, 0.0], [0.5, 0.0, 0.5]],
                               atol=1e-3)
    want = ref_sync.sinkhorn_balance(jnp.asarray(support.numpy()),
                                     jnp.asarray(col.numpy()))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_sinkhorn_random_support(seed):
    rng = np.random.default_rng(seed)
    support = (rng.random((5, 12)) < 0.6).astype(np.float32)
    col = rng.random(12).astype(np.float32)
    got = global_sync.sinkhorn_balance(torch.as_tensor(support),
                                       torch.as_tensor(col), n_iters=32)
    want = ref_sync.sinkhorn_balance(jnp.asarray(support), jnp.asarray(col),
                                     n_iters=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,j", ((2, 3), (40, 8), (3, 70), (128, 1024)))
def test_sinkhorn_orders_its_sums_as_the_reference(s, j):
    """Past 32 servers or jobs XLA sums by windows of 32; up to 32 jobs it
    fuses the row scaling's product into the row sum (one fused
    multiply-add a step); segments driven toward 0 pass through the
    subnormals, which it flushes.  Every segment equal, also jitted and
    over a lane axis."""
    import jax
    rng = np.random.default_rng(s * j)
    support = (rng.random((3, s, j)) < 0.5).astype(np.float32)
    col = rng.random((3, j)).astype(np.float32)
    got = global_sync.sinkhorn_balance(torch.as_tensor(support),
                                       torch.as_tensor(col))
    want = jax.jit(jax.vmap(ref_sync.sinkhorn_balance))(
        jnp.asarray(support), jnp.asarray(col))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ("priority-fair", "user:priority",
                                  "group-user-size-fair"))
def test_chain_row_sums_in_the_reference_order(name):
    """Non-dyadic priorities over 100 slots: the row sums of the chain's
    transition matrices run over more than 32 columns, by windows of 32 of
    the composite ids; every share equal."""
    import jax
    rng = np.random.default_rng(5)
    jobs = [dict(user=int(rng.integers(0, 40)), group=int(rng.integers(0, 3)),
                 size=int(rng.integers(1, 64)),
                 priority=float(rng.random() * 3 + 0.1)) for _ in range(100)]
    rt, tt = ref_jt.make_table(jobs, max_jobs=100), make_table(jobs, 100)
    demand = rng.random(100) < 0.7
    rp = ref_policy.Policy.parse(name)
    want = jax.jit(lambda d: ref_policy.compute_job_shares_from_table(
        rp, rt, demand=d))(jnp.asarray(demand))
    chain = PolicyChain.from_table(Policy.parse(name), tt)
    got = chain.shares(chain.active & torch.as_tensor(demand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ("user-fair", "size-fair",
                                  "group-user-size-fair"))
def test_sync_and_local_segments_match_reference(name):
    rt, tt = both_tables(random_jobs(11))
    demand = np.random.default_rng(3).random((6, J)) < 0.4
    chain = PolicyChain.from_table(Policy.parse(name), tt)
    rp = ref_policy.Policy.parse(name)
    got = global_sync.local_segments(chain, torch.as_tensor(demand))
    want = ref_sync.local_segments(rp, rt, jnp.asarray(demand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = global_sync.sync_segments(chain, torch.as_tensor(demand))
    want = ref_sync.sync_segments(rp, rt, jnp.asarray(demand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_hash_matches_reference():
    assert params.ThemisParams().params_hash() == \
        ref_params.ThemisParams().params_hash()
    assert params.FifoParams().params_hash() == \
        ref_params.FifoParams().params_hash()
    assert params.ThemisParams().params_hash() != \
        params.FifoParams().params_hash()
