"""The port's serving path against the JAX package, on the CPU.

The port's ``ServeEngine`` and the reference's run the scenarios of
``tests/test_serve.py`` (shortened) on the same parameters (carried across
with ``params_from_numpy``) and the same prompts.  The admission draws use
bit-exact copies of ``jax.random``'s threefry and the same policy chain, so
the tenant admission sequence must be equal, and so must every request's
greedy tokens and the tokens decoded per tenant (float32, reduced
h2o-danube-1.8b, zamba2-2.7b and rwkv6-7b: the logits agree to ~1e-5, far
inside every argmax gap these prompts meet).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.launch import serve as ref_launch
from repro.models import model as RM
from repro.serve import engine as ref_engine
from repro.serve import serve_step as ref_steps
from repro_torch.configs.base import get_config
from repro_torch.core import convert
from repro_torch.kernels.token_select import ops as tk_ops
from repro_torch.launch import serve as launch
from repro_torch.serve import engine as port_engine
from repro_torch.serve import serve_step as steps

ARCH = "h2o-danube-1.8b"


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    ref_params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                       cfg)
    return rcfg, cfg, ref_params, params


class _RefEngine(ref_engine.ServeEngine):
    """The reference engine, recording the tenant of every admission."""

    def _start(self, slot, req):
        self.admitted.append(req.tenant.tenant_id)
        super()._start(slot, req)


class _PortEngine(port_engine.ServeEngine):
    def _start(self, slot, req):
        self.admitted.append(req.tenant.tenant_id)
        super()._start(slot, req)


def both(setup, submit, steps=None, **kw):
    """Run ``submit(engine, Tenant)`` then ``run(steps)`` (or ``drain``) on
    the reference and on the port; returns (ref engine, ref requests, port
    engine, port requests)."""
    rcfg, cfg, ref_params, params = setup
    out = []
    for cls, c, p, tenant, extra in (
            (_RefEngine, rcfg, ref_params, ref_engine.Tenant, {}),
            (_PortEngine, cfg, params, port_engine.Tenant,
             dict(device="cpu"))):
        eng = cls(c, p, **kw, **extra)
        eng.admitted = []
        reqs = submit(eng, tenant)
        if steps is None:
            eng.drain()
        else:
            eng.run(steps)
        out += [eng, reqs]
    return out


def assert_same(ref, ref_reqs, eng, reqs):
    assert eng.admitted == ref.admitted
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert [r.finished_at for r in reqs] == [r.finished_at for r in ref_reqs]
    assert eng.decoded_per_tenant == ref.decoded_per_tenant
    assert eng.step_count == ref.step_count


def test_user_fair_single_request(setup):
    def submit(eng, tenant_cls):
        prompt = np.random.default_rng(0).integers(0, eng.cfg.vocab, size=6)
        return [eng.submit(tenant_cls(tenant_id=1, user=1), prompt,
                           max_new=5)]
    ref, ref_reqs, eng, reqs = both(setup, submit, batch_slots=2, max_len=48,
                                    policy="user-fair")
    assert reqs[0].finished_at is not None and len(reqs[0].out_tokens) == 5
    assert_same(ref, ref_reqs, eng, reqs)


def test_size_fair_backlog(setup):
    """Two backlogged tenants of sizes 3 and 1 over 60 engine steps (the
    reference test runs 250; the admission sequence is compared draw by
    draw, so a shorter window checks the same thing)."""
    def submit(eng, tenant_cls):
        big = tenant_cls(tenant_id=1, user=1, size=3)
        small = tenant_cls(tenant_id=2, user=2, size=1)
        rng = np.random.default_rng(1)
        reqs = []
        for _ in range(40):
            reqs.append(eng.submit(big, rng.integers(0, eng.cfg.vocab, size=4),
                                   max_new=10))
            reqs.append(eng.submit(small, rng.integers(0, eng.cfg.vocab,
                                                       size=4), max_new=10))
        return reqs
    ref, ref_reqs, eng, reqs = both(setup, submit, steps=60, batch_slots=4,
                                    max_len=64, policy="size-fair", seed=1)
    assert eng.queues[1] and eng.queues[2], "window must stay backlogged"
    assert len(eng.admitted) >= 20 and eng.admitted.count(1) > \
        eng.admitted.count(2)
    assert_same(ref, ref_reqs, eng, reqs)


def test_idle_tenant_work_conservation(setup):
    def submit(eng, tenant_cls):
        only = tenant_cls(tenant_id=5, user=5)
        rng = np.random.default_rng(2)
        return [eng.submit(only, rng.integers(0, eng.cfg.vocab, size=4),
                           max_new=6) for _ in range(4)]
    ref, ref_reqs, eng, reqs = both(setup, submit, steps=40, batch_slots=2,
                                    max_len=64, policy="user-fair", seed=2)
    assert eng.decoded_per_tenant.get(5, 0) >= 24
    assert_same(ref, ref_reqs, eng, reqs)


def test_admission_draws_through_token_select(setup, monkeypatch):
    """Each admission is one token_select call (its plain version here: no
    kernel launch on the CPU)."""
    _, cfg, _, params = setup
    calls = []
    real = port_engine.select_job
    monkeypatch.setattr(port_engine, "select_job",
                        lambda *args: calls.append(args) or real(*args))
    eng = port_engine.ServeEngine(cfg, params, batch_slots=2, max_len=32,
                                  device="cpu")
    before = tk_ops.LAUNCHES
    t = port_engine.Tenant(tenant_id=0)
    for _ in range(3):
        eng.submit(t, np.arange(3), max_new=2)
    eng.drain()
    assert tk_ops.LAUNCHES == before
    assert len(calls) == 3
    assert all(c[0].shape == (16,) for c in calls)


def test_serve_steps_match(setup):
    """make_prefill_step / make_decode_step: logits (1e-4) and greedy
    tokens, three steps."""
    rcfg, cfg, ref_params, params = setup
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 20))
    ref_pf = ref_steps.make_prefill_step(rcfg, max_len=32)
    ref_dec = ref_steps.make_decode_step(rcfg)
    rl, rc = ref_pf(ref_params, {"tokens": jnp.asarray(tokens)})
    tl, tc = steps.make_prefill_step(cfg, max_len=32)(
        params, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4,
                               atol=1e-4)
    dec = steps.make_decode_step(cfg)
    nxt = np.argmax(np.asarray(rl), -1).astype(np.int32)
    for i in range(3):
        pos = np.full((2,), 20 + i, np.int32)
        rl, rn, rc = ref_dec(ref_params, rc, {"tokens": jnp.asarray(nxt)},
                             jnp.asarray(pos))
        tl, tn, tc = dec(params, tc, {"tokens": torch.as_tensor(nxt)},
                         torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
        nxt = np.array(rn)


def test_serve_cli_matches_reference(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --device cpu`` against
    ``python -m repro.launch.serve``: the same completions, ticks and
    tokens per tenant (their own random parameters: the outputs compared
    do not depend on token values)."""
    monkeypatch.setattr(sys, "argv", ["serve", "--requests", "9",
                                      "--policy", "size-fair"])
    ref_launch.main()
    ref_out = capsys.readouterr().out.splitlines()
    eng, reqs = launch.main(["--requests", "9", "--policy", "size-fair",
                             "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" (")[0] == ref_out[0]
    assert out[1] == ref_out[1]
    assert all(r.finished_at is not None for r in reqs)


@pytest.fixture(scope="module", params=["zamba2-2.7b", "rwkv6-7b"])
def recurrent_setup(request):
    rcfg = ref_get_config(request.param, reduced=True)
    cfg = get_config(request.param, reduced=True)
    ref_params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                       cfg)
    return rcfg, cfg, ref_params, params


def test_recurrent_engine_matches_reference(recurrent_setup):
    """Reduced zamba2 / rwkv6 in ServeEngine, request tokens equal to the
    reference engine's.  Both engines feed a new slot's prompt by decode
    steps over every slot, so the recurrent states (mamba h/conv, rwkv
    s/prev/cm_prev) of the other active slots advance once per fed prompt
    token: the requests admitted while another is decoding see that, and
    the port must match the reference token for token all the same."""
    def submit(eng, tenant_cls):
        rng = np.random.default_rng(4)
        tenants = [tenant_cls(tenant_id=i, user=i, size=1 + i)
                   for i in range(2)]
        return [eng.submit(tenants[i % 2],
                           rng.integers(0, eng.cfg.vocab, size=3 + i % 4),
                           max_new=4 + i % 3) for i in range(6)]
    ref, ref_reqs, eng, reqs = both(recurrent_setup, submit, batch_slots=2,
                                    max_len=48, policy="size-fair", seed=3)
    assert all(r.finished_at is not None for r in reqs)
    assert len(eng.admitted) == 6
    assert_same(ref, ref_reqs, eng, reqs)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_serve_cli_runs_recurrent_archs(arch, monkeypatch, capsys):
    """``--arch zamba2-2.7b`` / ``rwkv6-7b`` with ``--device cpu``: the
    same completions, ticks and tokens per tenant as the reference CLI."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--requests",
                                      "5"])
    ref_launch.main()
    ref_out = capsys.readouterr().out.splitlines()
    eng, reqs = launch.main(["--arch", arch, "--requests", "5", "--device",
                             "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert eng.cfg.name == arch
    assert out[0].split(" (")[0] == ref_out[0]
    assert out[1] == ref_out[1]
    assert all(r.finished_at is not None for r in reqs)


def test_engine_defaults_to_the_card(setup, monkeypatch):
    _, cfg, _, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_engine.ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--requests", "1"])
