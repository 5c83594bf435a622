"""The PyTorch port stands alone: it imports with ``jax`` blocked, loads
nothing of ``repro``, runs on the card unless asked for the CPU, and refuses
what cannot run where it is asked for."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.")
             or m == "jax" and sys.modules[m] is not None)
assert not bad, bad
for sub in ("workspace.store", "workspace.campaign", "batch.sim",
            "batch.plan", "batch.bridge", "bench.batch", "core.shard",
            "launch.mesh", "bench.fleet", "bench.scaling", "bench.composite",
            "bench.apps", "bench.lambda_sync", "bench.kernels", "bench.tick",
            "bench.run", "bench.trend", "bench.calibrate", "roofline",
            "roofline.analysis"):
    assert "repro_torch." + sub in names, sub
print(len(names))
"""


def test_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_no_source_imports_jax_repro_or_benchmarks():
    """Every module of the port and chip_smoke.py, read as source: no import
    of ``jax``, ``repro`` or ``benchmarks`` anywhere, a function body's
    included (the import test above only runs module-level imports)."""
    import ast
    import pathlib
    root = pathlib.Path(REPO)
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(root)}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "repro", "benchmarks")]
    assert len(files) > 80 and not bad, bad


def test_package_import_is_lazy():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys, repro_torch; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_a_card_raises(no_card, tmp_path):
    from repro_torch import resolve_device
    from repro_torch.api import Experiment
    from repro_torch.core.engine import EngineConfig, make_workload
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        make_workload(EngineConfig(scheduler="fifo"), [dict(procs=4)])
    with pytest.raises(RuntimeError, match="cuda"):
        Experiment(scheduler="fifo").add_job(procs=4).run(0.01)
    with pytest.raises(RuntimeError, match="cuda"):
        Experiment(scheduler="fifo").add_job(procs=4).solo(
            0, 0.01, workspace=str(tmp_path))
    bx = Experiment.batch("bb-heavy", n_jobs=4)
    for policy in ("fcfs", "plan"):
        with pytest.raises(RuntimeError, match="cuda"):
            bx.run(policy)
    from repro_torch.bench import calibrate, kernels, scaling, tick
    for section in (lambda: tick.run_kern(iters=1),
                    lambda: kernels.run_micro(iters=1),
                    lambda: scaling.run_fig7(scale=0.001, servers=(1,)),
                    lambda: calibrate.calibrate_plan(0.01, (0,))):
        with pytest.raises(RuntimeError, match="cuda"):
            section()
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_features_refuse():
    """Fleet sharding outside a world of enough ranks is refused with the
    reference's ValueError, naming the launcher; the six schedulers,
    Poisson phases, run_batch, scenario trees, the service and the batch
    plane run."""
    from repro_torch.api import Experiment
    from repro_torch.bb.service import BBCluster
    from repro_torch.core import engine
    from repro_torch.core.policy import Policy
    from repro_torch.scenario import Scenario, leaf, repeat
    from repro_torch.scenario.lowering import lower
    for name in ("themis", "fifo", "gift", "tbf", "adaptbf", "plan"):
        engine.EngineConfig(scheduler=name, device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        engine.EngineConfig(scheduler="fiffo", device="cpu")
    with pytest.raises(ValueError, match="launch.mesh.spawn"):
        engine.EngineConfig(scheduler="fifo", shard_servers=2, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        BBCluster(mesh_shape=(2, 1), device="cpu")
    assert Experiment.batch(n_jobs=4, device="cpu").run("easy").start.shape \
        == (4,)
    with pytest.raises(TypeError):
        lower(object())
    tree = repeat(leaf(dict(procs=4, phases=[dict(start_s=0.0,
                                                  duration_s=0.01)])), 2,
                  period_s=0.02)
    assert lower(tree).phase_start.shape == (1, 2)
    assert lower(Scenario(tree=tree)).phases == lower(tree).phases
    cfg = engine.EngineConfig(scheduler="themis", policy=Policy.parse("job-fair"),
                              device="cpu", n_servers=1, max_jobs=4)
    wl, table = engine.make_workload(cfg, [dict(procs=4, arrival="poisson",
                                                rate_hz=200.0)])
    assert engine.run(cfg, wl, table, 0.05)["issued"].sum() > 0
    res = Experiment(scheduler="fifo", device="cpu").add_job(
        procs=4).run_batch(0.01, seeds=(0, 1))
    assert res.completed.shape[0] == 2


def test_service_modules_and_pins_load_without_jax():
    """The scenario package, the trace importer, the file system and the
    service import with ``jax`` blocked, and the port reads the lowering
    pins of ``tests/data`` (numpy only) to the reference's arrays."""
    code = r"""
import base64, json, sys
sys.modules["jax"] = None
import numpy as np
from repro_torch import bb, fs, scenario
from repro_torch.api import Experiment
from repro_torch.scenario import trace
assert trace.TRACE_FIELDS == scenario.TRACE_FIELDS
pins = json.load(open("tests/data/lowering_pins.json"))
case = pins["preset-bursty-interferer"]
exp = Experiment.from_scenario(scenario.preset("bursty-interferer"),
                               policy="job-fair", n_workers=2, device="cpu")
wl = exp.build()[1]
for name, arr in case["arrays"].items():
    nd = arr["__ndarray__"]
    want = np.frombuffer(base64.b64decode(nd["data"]), nd["dtype"])
    assert (getattr(wl, name).numpy() == want.reshape(nd["shape"])).all()
c = bb.BBCluster(n_servers=2, device="cpu")
assert c.fs.ring.server_of("/x") in (0, 1)
print(sorted(m for m in sys.modules if m.startswith(("repro.", "jax"))
             and sys.modules[m] is not None))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_kernel_wrappers_refuse_bf16_and_bad_shapes():
    from repro_torch.kernels.tick_step.ops import tick_step
    from repro_torch.kernels.token_select.ops import token_select
    shares = torch.rand(2, 8)
    q = torch.ones(2, 8, dtype=torch.int32)
    u = torch.rand(2, 3)
    # bf16 shares are taken (drawn in bf16, as the reference draws them);
    # other dtypes are refused.
    picks = token_select(shares.to(torch.bfloat16), q, u)
    assert picks.dtype == torch.int32 and picks.shape == (2, 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        token_select(shares.half(), q, u)
    with pytest.raises(ValueError):
        token_select(shares, q[:1], u)
    window = torch.rand(2, 8, 3)
    free = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="mode"):
        tick_step(shares, q, window, free, u, mode="lifo")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tick_step(shares.double(), q, window, free, u)
    with pytest.raises(ValueError):
        tick_step(shares, q, window[:, :, :2], free, u)
