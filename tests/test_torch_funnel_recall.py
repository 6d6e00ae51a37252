"""The port's device funnel end to end (``device_funnel_recall``: the legs,
the pool program on a CPU engine, the epilogue) against the JAX package's
``MemorySystem.recall``, on the CPU.

The reference of ``test_torch_rank_pool.py`` serves the query set readonly,
at the default device-spreading threshold and with it patched to 0 (the
graph leg then runs ``DeviceSpreader``), while a spy records what each
``_device_funnel_recall`` call returned. The port opens the same data
directory and must answer every call with the same ranked memories,
scores and attributions, ``device_funnel`` included, and give None where the
reference fell through to the staged funnel.
"""

from types import SimpleNamespace

import pytest

import shodh_tpu.constants as ref_constants
import test_torch_rank_pool as trp
from shodh_tpu.engine.memory_system import MemorySystem
from shodh_tpu.types import Query as RefQuery
from shodh_tpu_torch import constants as port_constants
from shodh_tpu_torch.engine import funnel_legs as fl
from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
from shodh_tpu_torch.types import Query

MODES = ("host", "device")
# fall-through envs, each with a query it must send to the staged funnel
FALL_THROUGH = [
    ({"SHODH_FUSION_RRF": "1"}, "kiln glaze mugs"),
    ({"SHODH_FLAT_VEC_TRUST": "0.5"}, "Lisbon shelter puppy"),
    ({"SHODH_ENUM_DAY_UNION": "1"}, "What trips has Ravi taken?"),
]


def _record(data_dir, queries, env=()):
    calls = []
    orig = MemorySystem._device_funnel_recall

    def spy(self, query, k, now, t_start):
        out = orig(self, query, k, now, t_start)
        calls.append((query, k, now, None if out is None else trp.snapshot(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHODH_EVAL_NOW", trp.NOW_ISO)
        mp.setenv("SHODH_DEVICE_FUNNEL", "1")
        mp.setenv("SHODH_RECALL_READONLY", "1")
        for name, value in env:
            mp.setenv(name, value)
        mp.setattr(MemorySystem, "_device_funnel_recall", spy)
        ref = MemorySystem(data_dir)
        for mode in MODES:
            if mode == "device":
                mp.setattr(ref_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
            for q in queries:
                ref.recall(RefQuery(**{"max_results": 8, **q}))
        ref.close()
    return calls


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("funnel_recall") / "store"
    trp.build_store(root)
    device = [q for q, caller in trp.QUERIES if caller == "device"]
    calls = _record(root, device)
    fall = [_record(root, [{"query_text": text}], env.items()) for env, text in FALL_THROUGH]
    holder = trp.port_holder(root)
    yield SimpleNamespace(calls=calls, fall=fall, holder=holder, n=len(device))
    trp.close_holder(holder)


@pytest.fixture
def threshold(request, monkeypatch):
    monkeypatch.setenv("SHODH_EVAL_NOW", trp.NOW_ISO)
    monkeypatch.setenv("SHODH_RECALL_READONLY", "1")
    if request.param == "device":
        monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    return request.param


@pytest.mark.parametrize("threshold", MODES, indirect=True)
def test_device_funnel_recall_equals_reference_recall(served, threshold):
    """Ids in order, scores and every attribution to rtol 1e-5."""
    engine = DeviceRecallEngine(served.holder)
    lo = MODES.index(threshold) * served.n
    calls = served.calls[lo:lo + served.n]
    assert len(calls) == served.n and all(want for *_, want in calls)
    for query, k, now, want in calls:
        got = fl.device_funnel_recall(served.holder, engine, trp.port_query(query), k, now)
        trp.same_results(trp.snapshot(got), want)
        assert all(a["device_funnel"] == 1.0 for _, _, a in want)
        assert {"analyze_ms", "embed_ms", "graph_ms", "bm25_ms", "device_pool_ms", "fusion_ms",
                "load_ms", "score_ms", "learned_ms", "companion_ms",
                "total_ms"} <= set(got.stage_timings_ms)
    if threshold == "device":
        assert served.holder.graph._device_spreader_inst is not None


def test_spreading_paths_rank_apart(served):
    """The two thresholds give the graph leg other values (R8), so the two
    passes check different inputs of the epilogue."""
    host, device = served.calls[:served.n], served.calls[served.n:]
    assert [c[3] for c in host] != [c[3] for c in device]


@pytest.mark.parametrize("case", range(len(FALL_THROUGH)))
def test_none_where_the_reference_falls_through(served, case, monkeypatch):
    env, text = FALL_THROUGH[case]
    calls = served.fall[case]
    assert calls and all(want is None for *_, want in calls)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    engine = DeviceRecallEngine(served.holder)
    for query, k, now, _ in calls:
        assert fl.device_funnel_recall(served.holder, engine, trp.port_query(query), k, now) is None


def test_device_errors_reach_the_caller(served):
    """Unlike the reference, which serves the staged funnel after any error
    of the pool call, the port lets a device error through."""
    class Broken:
        def recall_pool(self, *args, **kwargs):
            raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        fl.device_funnel_recall(served.holder, Broken(), Query(query_text="kiln glaze"), 8, trp.NOW)


def test_empty_index_gives_none(served, tmp_path):
    holder = SimpleNamespace(**{**vars(served.holder),
                                "index": type(served.holder.index)(384, device="cpu")})
    assert fl.device_funnel_recall(holder, DeviceRecallEngine(holder),
                                   Query(query_text="kiln glaze"), 8, trp.NOW) is None
