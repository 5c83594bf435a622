"""The port's scenario layer against the reference's, on the same inputs:
combinator trees, ``Scenario`` JSON, the preset library, the trace
importer, the Experiment builder's ``phase``/``bursts``/``ramp`` sugar, the
lowering pins of ``tests/data`` and a phased preset run."""
import json
import os
import sys

import numpy as np
import pytest

import repro.api as ref_api
import repro.scenario as ref_scn
from repro.workspace.store import decode_payload
from repro_torch import api
import repro_torch.scenario as scn

DATA = os.path.join(os.path.dirname(__file__), "data")
PACKAGES = {"ref": ref_scn, "port": scn}


def both(fn):
    """``fn(module)`` for the reference's and the port's scenario package."""
    return fn(ref_scn), fn(scn)


# -- combinator trees ----------------------------------------------------------

def _frag(m):
    return m.leaf(dict(user=0, procs=4, req_mb=2,
                       phases=[dict(start_s=0.0, duration_s=0.1)]))


TREES = {
    "leaf": lambda m: m.leaf([dict(user=0, procs=4, end_s=0.3),
                              dict(user=1, size=2, priority=2.0,
                                   servers=[0], overhead_us=5.0)]),
    "repeat": lambda m: m.repeat(_frag(m), 3, period_s=0.2),
    "repeat-span": lambda m: m.repeat(_frag(m), 4),
    "concat": lambda m: m.concat(_frag(m), m.leaf(dict(user=1, end_s=0.2)),
                                 gap_s=0.05),
    "overlay": lambda m: m.overlay(_frag(m), m.shift(_frag(m), 0.3),
                                   m.leaf(dict(user=2, end_s=1.0))),
    "shift": lambda m: m.shift(_frag(m), 1.25),
    "scale": lambda m: m.scale(
        m.leaf(dict(user=0, procs=4, req_mb=3, think_s=0.01, end_s=0.4,
                    arrival="poisson", rate_hz=40.0)), time=2.5, req=0.5),
    "scale-interval": lambda m: m.scale(
        m.leaf(dict(user=0, end_s=0.4, arrival="interval",
                    interval_s=0.02)), time=0.5),
    "mask": lambda m: m.mask(m.repeat(_frag(m), 5, period_s=0.2),
                             start_s=0.15, end_s=0.65),
    "mix": lambda m: m.mix(*(m.leaf(dict(user=u, end_s=0.1))
                             for u in range(4)), seed=11),
    "mix-weights": lambda m: m.mix(m.leaf(dict(user=0, end_s=0.1)),
                                   m.leaf(dict(user=1, end_s=0.1)),
                                   seed=5, weights=(0.2, 0.8)),
    "or-sugar": lambda m: (m.leaf(dict(user=0, procs=4, end_s=0.1))
                           | m.leaf(dict(user=1, procs=4, end_s=0.1))),
    "rshift-sugar": lambda m: (_frag(m) >> _frag(m)) >> m.leaf(
        dict(user=0, procs=4, req_mb=2, end_s=0.05)),
    "nested": lambda m: m.overlay(
        m.repeat(_frag(m), 3, period_s=0.2),
        m.mask(m.leaf(dict(user=1, procs=4, req_mb=1, end_s=0.3)),
               start_s=0.1, end_s=0.25),
        m.mix(m.concat(m.leaf(dict(user=2, procs=4, end_s=0.2)),
                       m.leaf(dict(user=2, procs=4, end_s=0.2)),
                       gap_s=0.05),
              m.leaf(dict(user=2, procs=4, end_s=0.2)), seed=7)),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_trees_expand_and_serialize_as_the_reference(name):
    ref_tree, port_tree = both(TREES[name])
    assert scn.to_jobs(port_tree) == ref_scn.to_jobs(ref_tree)
    doc = scn.node_to_doc(port_tree)
    assert doc == ref_scn.node_to_doc(ref_tree)
    # the port reads the reference's document back to the same tree
    again = scn.node_from_doc(json.loads(json.dumps(ref_scn.node_to_doc(ref_tree))))
    assert again == port_tree
    assert scn.NODE_OPS == ref_scn.NODE_OPS


@pytest.mark.parametrize("seed", range(12))
def test_mix_picks_as_the_reference(seed):
    pick = lambda m: m.to_jobs(m.mix(  # noqa: E731
        *(m.leaf(dict(user=u, end_s=0.1)) for u in range(3)), seed=seed,
        weights=(1.0, 2.0, 3.0)))[0]["user"]
    a, b = both(pick)
    assert a == b


BAD_CALLS = {
    "repeat-n": lambda m: m.repeat(_frag(m), 0),
    "repeat-period": lambda m: m.repeat(_frag(m), 2, period_s=-1.0),
    "repeat-open": lambda m: m.to_jobs(m.repeat(m.leaf(dict(user=0)), 2)),
    "concat-open": lambda m: m.to_jobs(m.concat(m.leaf(dict(user=0)),
                                                _frag(m))),
    "concat-gap": lambda m: m.concat(_frag(m), gap_s=-0.1),
    "concat-empty": lambda m: m.concat(),
    "overlay-child": lambda m: m.overlay(_frag(m), "x"),
    "shift-child": lambda m: m.shift([dict(user=0)], 1.0),
    "scale-time": lambda m: m.scale(_frag(m), time=0.0),
    "scale-req": lambda m: m.scale(_frag(m), req=-2.0),
    "mask-window": lambda m: m.mask(_frag(m), start_s=0.5, end_s=0.5),
    "mix-weights": lambda m: m.mix(_frag(m), _frag(m), weights=(1.0,)),
    "mix-negative": lambda m: m.mix(_frag(m), _frag(m), weights=(1.0, -1.0)),
    "leaf-typo": lambda m: m.leaf(dict(user=0, req_md=3)),
    "to_jobs-type": lambda m: m.to_jobs([dict(user=0)]),
    "doc-op": lambda m: m.node_from_doc({"op": "swithc", "children": []}),
    "doc-type": lambda m: m.node_from_doc(["leaf"]),
    "scenario-both": lambda m: m.Scenario(jobs=[dict(user=0)],
                                          tree=m.leaf(dict(user=0))),
    "scenario-tree-type": lambda m: m.Scenario(tree=[dict(user=0)]),
    "scenario-job": lambda m: m.Scenario(jobs=[dict(user=0, phases=[
        dict(start_s=0.0, end_s=0.2), dict(start_s=0.1, end_s=0.3)])]),
    "preset-name": lambda m: m.preset("nope"),
}


def _raised(fn, m):
    try:
        fn(m)
    except Exception as e:     # noqa: BLE001 - the type is what is compared
        return type(e), str(e)
    return None, None


@pytest.mark.parametrize("name", sorted(BAD_CALLS))
def test_bad_trees_refused_as_the_reference(name):
    (ta, ma), (tb, mb) = both(lambda m: _raised(BAD_CALLS[name], m))
    assert ta is not None and ta is tb, (ta, tb)
    assert mb == ma


# -- Scenario JSON -------------------------------------------------------------

def _exp(mod, **kw):
    return (mod.Experiment(policy="job-fair", scheduler="themis", n_workers=2,
                           **kw)
            .add_job(user=0, procs=4, req_mb=5, end_s=0.6)
            .add_job(user=1, procs=4, req_mb=2)
            .bursts(period_s=0.3, duty=0.5, n=2))


def test_experiment_to_json_is_the_references_text():
    text = _exp(api, device="cpu").to_json("onoff-pin")
    assert text == _exp(ref_api).to_json("onoff-pin")
    again = scn.Scenario.from_json(text)
    assert again.jobs == scn.Scenario.from_json(text).jobs
    assert again.to_json() == text
    clone = api.Experiment.from_scenario(text, policy="job-fair",
                                         n_workers=2, device="cpu")
    assert clone.jobs == _exp(api, device="cpu").jobs


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_scenario_json_is_the_references_text(name, tmp_path):
    ref_tree, port_tree = both(TREES[name])
    text = scn.Scenario(tree=port_tree, name=name).to_json()
    assert text == ref_scn.Scenario(tree=ref_tree, name=name).to_json()
    path = tmp_path / "s.json"
    scn.Scenario(tree=port_tree, name=name).save(str(path))
    loaded = scn.Scenario.load(str(path))
    assert loaded.to_json() == text and loaded.tree == port_tree
    assert loaded.copy().to_json() == text
    assert ref_scn.Scenario.from_json(text).jobs == loaded.jobs


BAD_DOCS = (
    '{"name": "x"}', '[1, 2]', '{"version": 99, "jobs": []}',
    '{"version": "two", "jobs": []}', '{"version": 3, "jobs": []}',
    '{"jobs": [{"req_md": 3}]}', '{"jobs": [{"arrival": "bursty"}]}',
    '{"jobs": [{"phases": [{"start_s": 0.0}]}]}',
    '{"version": 2, "tree": {"op": "swithc", "children": []}}',
    '{"version": 2, "tree": {"op": "repeat", "n": 0, "child": '
    '{"op": "leaf", "jobs": [{"end_s": 1.0}]}}}',
    '{"version": 2, "tree": {"op": "mix", "children": []}}',
    '{"version": 2, "tree": 5}', 'not json',
)


@pytest.mark.parametrize("doc", BAD_DOCS)
def test_bad_documents_refused_as_the_reference(doc):
    (ta, ma), (tb, mb) = both(
        lambda m: _raised(lambda m: m.Scenario.from_json(doc), m))
    assert ta is not None and ta is tb, (ta, tb)
    assert mb == ma


def test_scenario_lowered_and_canonical_match_reference():
    tree_r, tree_p = both(TREES["nested"])
    kw = dict(dt=1e-3, n_servers=2, max_jobs=4)
    want = ref_scn.Scenario(tree=tree_r).lowered(**kw)
    got = scn.Scenario(tree=tree_p).lowered(**kw)
    for f in scn.lowering.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    cw, cg = want.canonical(), got.canonical()
    assert cg["attrs"] == cw["attrs"]
    assert set(cg["arrays"]) == set(cw["arrays"])
    assert scn.lowering.lower(tree_p, **kw).phases == want.phases


# -- presets -------------------------------------------------------------------

def test_presets_equal_the_references():
    want, got = ref_scn.presets(), scn.presets()
    assert list(got) == list(want)
    assert scn.PRESET_SECONDS == ref_scn.PRESET_SECONDS
    for name in want:
        assert got[name].jobs == want[name].jobs
        assert got[name].to_json() == want[name].to_json()
        assert scn.preset(name).to_json() == ref_scn.preset(name).to_json()
    got["bursty-interferer"].jobs[1]["phases"][0]["req_mb"] = 999
    assert scn.presets()["bursty-interferer"].jobs == \
        want["bursty-interferer"].jobs
    assert scn.__all__ == ref_scn.__all__


# -- the trace importer --------------------------------------------------------

def _records():
    recs = [dict(rank=r, user=0, start_s=0.00 + 0.002 * r,
                 end_s=0.05 + 0.002 * r, bytes=8e6, op="write")
            for r in range(4)]
    recs += [dict(rank=r, user=0, start_s=0.30, end_s=0.35,
                  bytes=4e6, op="write") for r in range(4)]
    recs.append(dict(rank=0, user=3, start_s=0.0, end_s=0.4,
                     bytes=2e6, op="read"))
    recs.append(dict(rank=5, user=1, start_s=10.0, end_s=10.5,
                     bytes=3e5, op="read"))
    return recs


@pytest.mark.parametrize("knobs", [
    {}, dict(mode="closed"), dict(ops="write"), dict(ops=("read", "write")),
    dict(gap_s=0.01, time_scale=2.0), dict(min_phase_s=0.2),
])
def test_trace_import_matches_reference(knobs, tmp_path):
    recs = _records()
    cols = scn.TRACE_FIELDS
    csv_path = tmp_path / "t.csv"
    csv_path.write_text(
        ",".join(cols) + "\n" +
        "\n".join(",".join(str(r[c]) for c in cols) for r in recs) + "\n")
    jl_path = tmp_path / "t.jsonl"
    jl_path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    want = ref_scn.Scenario.from_trace(recs, name="t", **knobs).to_json()
    for source in (recs, str(csv_path), jl_path):
        assert scn.Scenario.from_trace(source, name="t", **knobs).to_json() \
            == want
    with open(jl_path) as f:
        assert scn.parse_trace(f) == ref_scn.parse_trace(str(jl_path))


TRACE_ERRORS = {
    "no-records": ([dict(start_s=0, end_s=1, op="write")], dict(ops="read")),
    "empty": ([], {}),
    "missing": ([dict(rank=0, end_s=1.0)], {}),
    "unknown-field": ([dict(start_s=0, end_s=1, sizee=3)], {}),
    "bad-window": ([dict(start_s=2.0, end_s=1.0)], {}),
    "bad-value": ([dict(start_s="soon", end_s=1.0)], {}),
    "not-a-dict": ([(0, 1)], {}),
    "mode": ([dict(start_s=0, end_s=1)], dict(mode="warp")),
    "time-scale": ([dict(start_s=0, end_s=1)], dict(time_scale=-1.0)),
    "gap": ([dict(start_s=0, end_s=1)], dict(gap_s=0.0)),
    "min-phase": ([dict(start_s=0, end_s=1)], dict(min_phase_s=0)),
    "knob-before-records": ([dict(bogus=1)], dict(time_scale=0)),
}


@pytest.mark.parametrize("name", sorted(TRACE_ERRORS))
def test_trace_errors_as_the_reference(name):
    recs, knobs = TRACE_ERRORS[name]
    (ta, ma), (tb, mb) = both(lambda m: _raised(
        lambda m: m.Scenario.from_trace(recs, **knobs), m))
    assert ta is not None and ta is tb, (ta, tb)
    assert mb == ma


# -- the Experiment builder's sugar ---------------------------------------------

BUILDERS = {
    "phase": lambda e: e.add_job(user=0, procs=6, req_mb=10)
    .phase(start_s=0.0, end_s=0.3).phase(start_s=0.3, end_s=0.8, req_mb=2.0,
                                         arrival="interval", interval_s=0.1),
    "bursts-n": lambda e: e.add_job(user=0, procs=4, req_mb=5, end_s=0.6)
    .add_job(user=1, procs=4, req_mb=2).bursts(period_s=0.3, duty=0.5, n=2),
    "bursts-end-s": lambda e: e.add_job(user=0, procs=4)
    .bursts(period_s=4.0, duty=0.25, end_s=10.0),
    "bursts-job": lambda e: e.add_job(user=0).add_job(user=1)
    .bursts(job=0, period_s=0.1, duty=1.0, n=20, start_s=0.3),
    "ramp": lambda e: e.add_job(user=0, procs=4, think_s=0.01)
    .ramp(start_s=0.2, duration_s=1.2, steps=4, req_mb=(1.0, 9.0),
          think_s=(0.0, 0.03)),
    "ramp-one": lambda e: e.add_job(user=0).ramp(start_s=0.0, duration_s=1.0,
                                                 steps=1, req_mb=(2.0, 4.0)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_sugar_matches_reference(name):
    want = BUILDERS[name](ref_api.Experiment(policy="job-fair"))
    got = BUILDERS[name](api.Experiment(policy="job-fair", device="cpu"))
    assert got.jobs == want.jobs
    assert got.to_json(name) == want.to_json(name)


BUILDER_ERRORS = {
    "phase-overlap": lambda e: e.add_job(user=0).phase(start_s=0.0, end_s=0.5)
    .phase(start_s=0.2, end_s=0.6),
    "phase-empty": lambda e: e.add_job(user=0).phase(start_s=0.5, end_s=0.5),
    "phase-no-job": lambda e: e.phase(start_s=0.0, end_s=1.0),
    "phase-index": lambda e: e.add_job(user=0).phase(job=3, start_s=0.0,
                                                     end_s=1.0),
    "phase-mode": lambda e: e.add_job(user=0).phase(start_s=0.0, end_s=1.0,
                                                    arrival="interval"),
    "bursts-duty": lambda e: e.add_job(user=0).bursts(period_s=1.0, duty=0.0,
                                                      n=2),
    "bursts-n-and-end": lambda e: e.add_job(user=0).bursts(
        period_s=1.0, duty=0.5, n=2, end_s=4.0),
    "bursts-short": lambda e: e.add_job(user=0).bursts(
        period_s=1.0, duty=0.5, end_s=0.2),
    "bursts-after-phase": lambda e: e.add_job(user=0)
    .phase(start_s=0.0, end_s=2.0).bursts(period_s=1.0, duty=0.5, n=2),
    "ramp-steps": lambda e: e.add_job(user=0).ramp(start_s=0.0,
                                                   duration_s=1.0, steps=0,
                                                   req_mb=(1, 2)),
    "ramp-fields": lambda e: e.add_job(user=0).ramp(start_s=0.0,
                                                    duration_s=1.0),
    "ramp-index": lambda e: e.add_job(user=0).ramp(job=-2, start_s=0.0,
                                                   duration_s=1.0,
                                                   req_mb=(1, 2)),
}


@pytest.mark.parametrize("name", sorted(BUILDER_ERRORS))
def test_builder_errors_roll_back_as_the_reference(name):
    """The same exception, and the spec left as it was before the failing
    call (the reference keeps phases that an earlier sugar window added
    before one failed; so does the port)."""
    out = []
    for exp in (ref_api.Experiment(policy="job-fair"),
                api.Experiment(policy="job-fair", device="cpu")):
        err = _raised(lambda _: BUILDER_ERRORS[name](exp), None)
        out.append((err, json.dumps(exp.jobs, sort_keys=True)))
    (ea, ja), (eb, jb) = out
    assert ea[0] is not None and ea[0] is eb[0], (ea, eb)
    assert eb[1] == ea[1]
    assert jb == ja


# -- the lowering pins -----------------------------------------------------------

@pytest.fixture(scope="module")
def pins():
    with open(os.path.join(DATA, "lowering_pins.json")) as f:
        doc = json.load(f)
    return {name: decode_payload(case["arrays"]) for name, case in doc.items()}


@pytest.fixture(scope="module")
def port_cases():
    """``gen_lowering_pins.experiments()`` rebuilt with the port's
    ``Experiment`` and scenario package (on the CPU)."""
    sys.path.insert(0, DATA)
    try:
        import gen_lowering_pins as gen
    finally:
        sys.path.pop(0)
    saved = (gen.Experiment, ref_scn.Scenario, ref_scn.presets)

    def port_experiment(*args, **kw):
        return api.Experiment(*args, device="cpu", **kw)

    port_experiment.from_scenario = lambda s, **kw: api.Experiment.from_scenario(
        s, device="cpu", **kw)
    gen.Experiment = port_experiment
    ref_scn.Scenario, ref_scn.presets = scn.Scenario, scn.presets
    try:
        cases = gen.experiments()
    finally:
        gen.Experiment, ref_scn.Scenario, ref_scn.presets = saved
    return gen, cases


def test_port_lowers_every_pinned_case_bit_for_bit(pins, port_cases):
    gen, cases = port_cases
    assert set(cases) == set(pins)
    for name, exp in cases.items():
        assert isinstance(exp, api.Experiment)
        _, wl, _ = exp.build()
        for f in gen.ARRAY_FIELDS:
            want = np.asarray(pins[name][f])
            got = getattr(wl, f).numpy()
            assert want.dtype == got.dtype and want.shape == got.shape, \
                (name, f, want.dtype, got.dtype, want.shape, got.shape)
            assert (want == got).all(), (name, f)


# -- a phased preset on both engines ----------------------------------------------

@pytest.mark.parametrize("scheduler", ("themis", "fifo"))
def test_phased_preset_run_is_counter_exact(scheduler):
    """``bursty-interferer`` (a two-phase job: the burster idle in the
    middle third) compressed to 0.6 s, 2 workers, on both engines."""
    tree = lambda m: m.scale(m.preset("bursty-interferer").tree,  # noqa: E731
                             time=0.6 / scn.PRESET_SECONDS)
    ref_tree, port_tree = both(tree)
    kw = dict(policy="job-fair", scheduler=scheduler, n_workers=2)
    want = ref_api.Experiment.from_scenario(
        ref_scn.Scenario(tree=ref_tree), **kw).run(0.6)
    got = api.Experiment.from_scenario(scn.Scenario(tree=port_tree),
                                       device="cpu", **kw).run(0.6)
    np.testing.assert_array_equal(got.issued, np.asarray(want.issued))
    np.testing.assert_array_equal(got.completed, np.asarray(want.completed))
    np.testing.assert_array_equal(got.gbps, np.asarray(want.gbps))
    assert got.dropped == int(want.dropped)
    assert int(np.asarray(want.completed)[1]) > 0
