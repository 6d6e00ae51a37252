"""The port's staged host funnel and ``index_retrieve`` against the JAX
package's, through ``MemorySystem.recall`` on the CPU (the port's with
``device="cpu"``).

Both packages' stores come from the ``stores`` fixture of
``test_torch_memory_system.py`` (240 seeded conversation turns, flushed),
with a dozen robotics experiences remembered on top (robots, missions,
places, actions and outcomes), so that every filter has memories to keep.
Each case copies both stores, runs the same queries on both systems with
usage writes on (the clock pinned), and holds the answers (ids in order,
scores rtol 1e-5, atol 1e-7) and then the stores (kv row for kv row) to
the reference's. Cases: every rung of the layer ladder, each filter of
``_is_plain_query``, an offset, a caller's embedding, the polar form, the
companion gate, ``SHODH_DEVICE_FUNNEL=0``, ``SHODH_FUSION_RRF=1``, an active
scoring A/B (its impressions), the enumeration day-bucket union,
``recall_with_diagnostics`` (the diagnostics and the armed gold funnel
equal), and ``index_retrieve``'s spatial, mission, filter-only and empty
queries.
"""

import shutil
from datetime import timedelta

import pytest

import shodh_tpu.engine.ab_testing as ref_ab
import shodh_tpu.harness.diagnostics as ref_diag
import shodh_tpu_torch.engine.ab_testing as port_ab
import shodh_tpu_torch.harness.diagnostics as port_diag
from shodh_tpu_torch.nlp.query_parser import QueryParser
from test_torch_memory_system import (  # noqa: F401 (stores is a fixture)
    BASE,
    SYSTEMS,
    assert_answers_equal,
    assert_stores_equal,
    open_system,
    pinned,
    seeded_sessions,
    stores,
)

DIAG = {"ref": ref_diag, "port": port_diag}
AB = {"ref": ref_ab, "port": port_ab}
LADDER = ("vector_only", "+spreading", "+bm25", "+rerank", "+facts", "full")
TEXTS = ("What did Melanie say about the pottery studio?", "why did the kafka cluster fail over",
         "Caroline dog shelter puppy", "What did Dana do in Lisbon last week?")
POLAR = "Did Melanie glaze the mugs in the kiln?"
MULTIHOP = "How is Melanie related to Caroline and the pottery studio?"
ENUM = "What activities has Melanie done at the beach?"
LISBON = (38.7223, -9.1393)
NOW = BASE + timedelta(days=2)


def robotics(types) -> list:
    """Twelve experiences a fleet of two robots would store on two missions."""
    out = []
    for i in range(12):
        lat = LISBON[0] + 0.001 * i * (1 if i % 2 else -1)
        out.append(types.Experience(
            content=f"robot r{i % 2} {'docked at' if i % 3 else 'mapped'} the pottery studio "
                    f"corridor {i} near the kiln",
            experience_type=types.ExperienceType.OBSERVATION if i % 4 else
            types.ExperienceType.TASK,
            tags=["fleet", f"mission-{i % 3}"],
            robot_id=f"r{i % 2}", mission_id=f"m{i % 3}", episode_id=f"ep{i % 4}",
            geo_location=(lat, LISBON[1], 10.0), action_type="navigate" if i % 2 else "grasp",
            outcome_type="success" if i % 3 else "failure", reward=0.1 * i,
            failure=i % 3 == 0, anomaly=i % 5 == 0, severity="high" if i % 5 == 0 else None,
            terrain_type="indoor" if i % 2 else "gravel"))
    return out


@pytest.fixture(scope="module")
def staged_stores(stores, tmp_path_factory):  # noqa: F811
    """The ``stores`` fixture's two stores with the robotics experiences."""
    root = tmp_path_factory.mktemp("staged")
    for name in SYSTEMS:
        shutil.copytree(stores / name, root / name)
        types, clock = SYSTEMS[name][1], SYSTEMS[name][3]
        system = open_system(name, root / name)
        with pinned(clock, BASE + timedelta(days=1, hours=2)), seeded_sessions(name, 7):
            system.batch_remember(robotics(types))
            system.close()
    return root


def _session_of(system) -> str:
    return sorted(m.experience.session_id for m in system.get_all(limit=1000)
                  if m.experience.session_id)[0]


def _embedding(system) -> list:
    return system.embedder.encode_query("pottery studio clay mugs").tolist()


def _ab(name, system):
    """A running scoring experiment with a fixed id (the reference draws
    ``uuid4``), two variants of fusion overrides."""
    mod = AB[name]
    exp = mod.Experiment(id="exp-0001", name="scoring:fusion", created_at=BASE,
                         variants={"a": {"vec_trust": 0.7}, "b": {"graph_weight_scale": 0.5}},
                         stats={"a": mod.VariantStats(), "b": mod.VariantStats()})
    exp.status = "running"
    system.ab._save(exp)


def _time_range(system) -> dict:
    return {"query_text": "pottery studio",
            "time_range": [(BASE + timedelta(hours=2)).isoformat(),
                           (BASE + timedelta(hours=20)).isoformat()]}


# Each case: the queries (dicts, or functions of the system that give one),
# the env, a setup run on each system before its queries, and whether the
# device funnel may serve it
FILTERS = {
    "time_range": _time_range,
    "tags": {"query_text": "pottery studio clay", "tags": ["conv-1"]},
    "experience_types": {"query_text": "pottery kiln", "experience_types": ["observation"]},
    "importance_threshold": {"query_text": "dog shelter puppy", "importance_threshold": 0.3},
    "episode_id": {"query_text": "robot corridor kiln", "episode_id": "ep1"},
    "session_id": lambda s: {"query_text": "cache latency", "session_id": _session_of(s)},
    "robot_id": {"query_text": "pottery studio corridor", "robot_id": "r1"},
    "mission_id": {"query_text": "pottery studio corridor", "mission_id": "m2"},
    "geo_filter": {"query_text": "robot corridor",
                   "geo_filter": {"lat": LISBON[0], "lon": LISBON[1], "radius_m": 500}},
    "action_type": {"query_text": "robot kiln", "action_type": "grasp"},
    "outcome_type": {"query_text": "robot kiln", "outcome_type": "failure"},
    "failures_only": {"query_text": "robot kiln corridor", "failures_only": True},
    "anomalies_only": {"query_text": "robot kiln corridor", "anomalies_only": True},
    "severity": {"query_text": "robot kiln corridor", "severity": "high"},
    "terrain_type": {"query_text": "robot kiln corridor", "terrain_type": "gravel"},
}
CASES = {
    **{f"layers[{rung}]": ([{"query_text": t, "layers": rung} for t in TEXTS], {}, None,
                           rung == "full") for rung in LADDER},
    **{f"filter[{f}]": ([q], {}, None, False) for f, q in FILTERS.items()},
    "offset": ([{"query_text": t, "offset": 3} for t in TEXTS[:2]], {}, None, False),
    "query_embedding": ([lambda s: {"query_text": "pottery", "query_embedding": _embedding(s)},
                         lambda s: {"query_embedding": _embedding(s), "max_results": 5}], {},
                        None, False),
    "polar[staged]": ([{"query_text": POLAR, "tags": ["conv-0"]},
                       {"query_text": POLAR, "layers": "+facts"}], {}, None, False),
    "companion_gate": ([{"query_text": MULTIHOP, "layers": "+rerank"},
                        {"query_text": MULTIHOP, "offset": 1}], {}, None, False),
    "device_funnel_off": ([{"query_text": t} for t in TEXTS + (POLAR, MULTIHOP)],
                          {"SHODH_DEVICE_FUNNEL": "0"}, None, False),
    "fusion_rrf": ([{"query_text": t} for t in TEXTS], {"SHODH_FUSION_RRF": "1"}, None, False),
    "scoring_ab": ([{"query_text": t} for t in TEXTS], {}, _ab, False),
    "enum_day_union": ([{"query_text": ENUM}, {"query_text": MULTIHOP},
                        {"query_text": ENUM, "max_results": 1}],
                       {"SHODH_ENUM_DAY_UNION": "1"}, None, False),
}
RETRIEVE = {
    "spatial": {"retrieval_mode": "spatial",
                "geo_filter": {"lat": LISBON[0], "lon": LISBON[1], "radius_m": 300}},
    "mission": {"retrieval_mode": "mission", "mission_id": "m1", "max_results": 3},
    "action_outcome": {"query_text": "grasp", "retrieval_mode": "action_outcome",
                       "action_type": "grasp"},
    "filter_only": {"tags": ["conv-2"], "experience_types": ["conversation"], "offset": 2},
    "filter_only_past_the_limit": {"experience_types": ["conversation"], "max_results": 5},
    "empty": {"max_results": 15},
}


def run_case(root, tmp_path, queries, setup=None, diagnostics=False, gold=None):
    """Each system over its own copy of its store (the same directory name,
    the A/B subject): the setup, then every query at ``NOW``; returns
    {package: [results]} after the close, and holds the stores equal."""
    out = {}
    for name in SYSTEMS:
        path = tmp_path / name / "user"
        shutil.copytree(root / name, path)
        system = open_system(name, path)
        diag = DIAG[name]
        try:
            with pinned(SYSTEMS[name][3], NOW):
                if setup is not None:
                    setup(name, system)
                results = []
                for q in queries:
                    q = q(system) if callable(q) else q
                    if gold is not None:
                        diag.arm("q", set(gold))
                    try:
                        r = system.recall_with_diagnostics(q) if diagnostics else system.recall(q)
                    finally:
                        record = diag.disarm() if gold is not None else None
                    results.append((r, record))
                system.close()
        finally:
            SYSTEMS[name][3].pin_now(None)
        out[name] = results
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")
    return out


def answers(results) -> list:
    return [[(s.memory.id, s.score) for s in r.memories] for r, _ in results]


@pytest.mark.parametrize("case", list(CASES))
def test_staged_recall_equals_reference(staged_stores, tmp_path, monkeypatch, case):
    queries, env, setup, device_ok = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = run_case(staged_stores, tmp_path, queries, setup)
    assert_answers_equal(answers(out["port"]), answers(out["ref"]))
    assert sum(map(len, answers(out["port"]))) > 0
    for name in SYSTEMS:
        served = {"device_funnel" in s.attribution for r, _ in out[name] for s in r.memories}
        assert served <= ({True, False} if device_ok else {False}), (name, served)


def test_cases_arm_their_branches():
    """The queries of the polar, companion and enumeration cases arm the
    branch they name, and the filters cover ``_is_plain_query``."""
    parser = QueryParser()
    assert parser.analyze(POLAR, now=NOW).negated_form
    assert parser.analyze(MULTIHOP, now=NOW).multihop
    assert parser.analyze(TEXTS[3], now=NOW).date_range is not None
    from shodh_tpu_torch.engine.funnel_legs import _enumeration_shape

    assert _enumeration_shape(ENUM)
    import inspect

    import shodh_tpu_torch.engine.memory_system as ms

    src = inspect.getsource(ms.MemorySystem._is_plain_query)
    assert {f for f in FILTERS if f"query.{f}" in src} == set(FILTERS)


def test_enum_day_union_runs_staged(staged_stores, tmp_path, monkeypatch):
    monkeypatch.setenv("SHODH_ENUM_DAY_UNION", "1")
    out = run_case(staged_stores, tmp_path, [{"query_text": ENUM}])
    for name in SYSTEMS:
        assert "enum_union_ms" in out[name][0][0].stage_timings_ms


@pytest.mark.parametrize("query", [{"query_text": t} for t in TEXTS]
                         + [{"query_text": MULTIHOP, "layers": "+bm25"}],
                         ids=["plain0", "plain1", "plain2", "temporal", "multihop_bm25"])
def test_recall_with_diagnostics_equals_reference(staged_stores, tmp_path, query):
    """The staged funnel serves every query with diagnostics; the answer, the
    diagnostics and the armed gold funnel's stage ranks are the reference's."""
    system = open_system("ref", staged_stores / "ref")
    try:
        gold = sorted(m.id for m in system.get_all(limit=1000))[::7]
    finally:
        system.storage.close()
        system.graph.close()
    out = run_case(staged_stores, tmp_path, [query], diagnostics=True, gold=gold)
    assert_answers_equal(answers(out["port"]), answers(out["ref"]))
    (got, got_rec), (want, want_rec) = out["port"][0], out["ref"][0]
    assert got.diagnostics == want.diagnostics and got.diagnostics["vector_candidates"] > 0
    assert got_rec.stage_ranks == want_rec.stage_ranks and "vector" in got_rec.stage_ranks
    assert got_rec.gold_ids == want_rec.gold_ids


@pytest.mark.parametrize("case", list(RETRIEVE))
def test_index_retrieve_equals_reference(staged_stores, tmp_path, case):
    out = run_case(staged_stores, tmp_path, [RETRIEVE[case]])
    got, want = answers(out["port"]), answers(out["ref"])
    assert_answers_equal(got, want)
    assert got[0], case


def test_index_retrieve_readonly_writes_nothing(staged_stores, tmp_path, monkeypatch):
    monkeypatch.setenv("SHODH_RECALL_READONLY", "1")
    run_case(staged_stores, tmp_path, [RETRIEVE["empty"], RETRIEVE["mission"]])
    assert_stores_equal(tmp_path / "port" / "user", staged_stores / "ref")


def test_staged_vector_leg_reads_the_store_row_map(staged_stores, tmp_path):
    """With the device funnel off, a recall never builds the engine (its own
    row map), and every vector-leg row maps through the store."""
    system = open_system("port", staged_stores / "port")
    try:
        calls = []
        orig = system.storage.memory_for_row
        system.storage.memory_for_row = lambda row, *a, **k: calls.append(row) or orig(row, *a, **k)
        with pinned(SYSTEMS["port"][3], NOW):
            r = system.recall({"query_text": TEXTS[0], "tags": ["conv-1"]})
        assert r.memories and calls and system._device_funnel is None
    finally:
        SYSTEMS["port"][3].pin_now(None)
        system.storage.close()
        system.graph.close()


class _DeviceError(RuntimeError):
    pass


@pytest.mark.parametrize("where", ["pool", "staged_search"])
def test_device_errors_reach_the_caller(staged_stores, tmp_path, where):
    """A device error of the device funnel's pool call, or of the staged
    vector leg's ``index.search``, reaches the caller: the port serves no
    other path instead (the reference serves the staged funnel after a
    failed pool call)."""
    shutil.copytree(staged_stores / "port", tmp_path / "s")
    system = open_system("port", tmp_path / "s")

    def fail(*args, **kwargs):
        raise _DeviceError(where)

    try:
        if where == "pool":
            from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine

            system._device_funnel = DeviceRecallEngine(system)
            system._device_funnel.recall_pool = fail
            query = {"query_text": TEXTS[0]}
        else:
            system.index.search = fail
            query = {"query_text": TEXTS[0], "tags": ["conv-1"]}
        with pinned(SYSTEMS["port"][3], NOW), pytest.raises(_DeviceError, match=where):
            system.recall(query)
    finally:
        SYSTEMS["port"][3].pin_now(None)
        system.storage.close()
        system.graph.close()
