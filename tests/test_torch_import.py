"""The torch port stands alone: no jax, nothing of shodh_tpu, its own copy of
the constants (equal to the reference's), and entry points that need a GPU
unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import shodh_tpu.constants as ref_constants
from shodh_tpu.engine.companion import DEEP_POOL_MULTIPLIER
from shodh_tpu.retrieval.fusion import FLAT_CONSENSUS, FLAT_CONSENSUS_NOTES
from shodh_tpu_torch import constants as port_constants
from shodh_tpu_torch import resolve_device
from shodh_tpu_torch.index.device_index import DeviceVectorIndex

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "shodh_tpu_torch",
    "shodh_tpu_torch.device",
    "shodh_tpu_torch.constants",
    "shodh_tpu_torch.ops.quant",
    "shodh_tpu_torch.ops.distance",
    "shodh_tpu_torch.ops._build",
    "shodh_tpu_torch.ops.fused_topk",
    "shodh_tpu_torch.ops.device_recall",
    "shodh_tpu_torch.index.device_index",
    "shodh_tpu_torch.graph.device_spreading",
    "shodh_tpu_torch.graph.relations",
    "shodh_tpu_torch.graph.plasticity",
    "shodh_tpu_torch.graph.topology",
    "shodh_tpu_torch.graph.graph_memory",
    "shodh_tpu_torch.types",
    "shodh_tpu_torch.utils.hashing",
    "shodh_tpu_torch.utils.clock",
    "shodh_tpu_torch.utils.geohash",
    "shodh_tpu_torch.storage.serialization",
    "shodh_tpu_torch.storage.kv",
    "shodh_tpu_torch.storage.store",
    "shodh_tpu_torch.engine.feedback",
    "shodh_tpu_torch.engine.scoring",
    "shodh_tpu_torch.engine.decay",
    "shodh_tpu_torch.engine.device_funnel",
    "shodh_tpu_torch.engine.funnel_legs",
    "shodh_tpu_torch.engine.tiers",
    "shodh_tpu_torch.engine.facts",
    "shodh_tpu_torch.engine.temporal_facts",
    "shodh_tpu_torch.engine.companion",
    "shodh_tpu_torch.engine.semantics",
    "shodh_tpu_torch.engine.rank_pool",
    "shodh_tpu_torch.harness.diagnostics",
    "shodh_tpu_torch.retrieval.fusion",
    "shodh_tpu_torch.retrieval.learned_fusion",
    "shodh_tpu_torch.models.semantic_model",
    "shodh_tpu_torch.nlp.normalize",
    "shodh_tpu_torch.nlp.norms",
    "shodh_tpu_torch.nlp.lemmas",
    "shodh_tpu_torch.nlp.stemmer",
    "shodh_tpu_torch.nlp.stopwords",
    "shodh_tpu_torch.nlp.causal_vocab",
    "shodh_tpu_torch.nlp.query_parser",
    "shodh_tpu_torch.nlp.openie",
    "shodh_tpu_torch.retrieval.spellfix",
    "shodh_tpu_torch.retrieval.native",
    "shodh_tpu_torch.retrieval.bm25",
    "shodh_tpu_torch.models.hash_embedder",
    "shodh_tpu_torch.models.embedder",
    "shodh_tpu_torch.models.chunking",
    "shodh_tpu_torch.engine.importance",
    "shodh_tpu_torch.nlp.ner",
    "shodh_tpu_torch.nlp.distilled_ner",
    "shodh_tpu_torch.nlp.gazetteer",
    "shodh_tpu_torch.engine.sessions",
    "shodh_tpu_torch.engine.interference",
    "shodh_tpu_torch.engine.replay",
    "shodh_tpu_torch.engine.lineage",
    "shodh_tpu_torch.engine.introspection",
    "shodh_tpu_torch.engine.ab_testing",
    "shodh_tpu_torch.utils.tracing",
    "shodh_tpu_torch.engine.memory_system",
    "shodh_tpu_torch.engine.staged_funnel",
    "shodh_tpu_torch.engine.prospective",
    "shodh_tpu_torch.engine.todos",
    "shodh_tpu_torch.engine.files",
    "shodh_tpu_torch.harness.fixtures",
    "shodh_tpu_torch.harness.metrics",
    "shodh_tpu_torch.harness.runner",
    "shodh_tpu_torch.harness.decay_sim",
    "shodh_tpu_torch.harness.agent_loop",
    "shodh_tpu_torch.cli",
    "shodh_tpu_torch.models.tokenizer",
    "shodh_tpu_torch.models.minilm",
    "shodh_tpu_torch.models.gliner",
    "shodh_tpu_torch.models.adjacency_metric",
    "shodh_tpu_torch.nlp.entity_type",
    "shodh_tpu_torch.nlp.dep_parser",
    "shodh_tpu_torch.nlp.learned_parser",
    "shodh_tpu_torch.storage.backup",
    "shodh_tpu_torch.storage.migration",
    "shodh_tpu_torch.engine.relevance",
    "shodh_tpu_torch.engine.visualization",
    "shodh_tpu_torch.engine.compression",
    "shodh_tpu_torch.nlp.entity_resolution",
    "shodh_tpu_torch.server.web",
    "shodh_tpu_torch.server.metrics",
    "shodh_tpu_torch.server.validation",
    "shodh_tpu_torch.server.state",
    "shodh_tpu_torch.server.telemetry",
    "shodh_tpu_torch.server.dashboard",
    "shodh_tpu_torch.server.app",
    "shodh_tpu_torch.server.local_ipc",
    "shodh_tpu_torch.nlp.segmentation",
    "shodh_tpu_torch.server.streaming",
    "shodh_tpu_torch.server.webhooks",
    "shodh_tpu_torch.server.integrations_sync",
    "shodh_tpu_torch.storage.mif",
    "shodh_tpu_torch.storage.mif_adapters",
    "shodh_tpu_torch.storage.fsck",
    "shodh_tpu_torch.engine.follower",
    "shodh_tpu_torch.server.replica",
    "shodh_tpu_torch.server.fleet",
    "shodh_tpu_torch.server.fleet_net",
    "shodh_tpu_torch.clients.client",
    "shodh_tpu_torch.clients.integrations",
    "shodh_tpu_torch.clients.mcp_server",
    "shodh_tpu_torch.clients.tui.data",
    "shodh_tpu_torch.clients.tui.state",
    "shodh_tpu_torch.clients.tui.render",
    "shodh_tpu_torch.clients.tui.shell",
    "shodh_tpu_torch.clients.tui.__main__",
    "shodh_tpu_torch.models.downloader",
    "shodh_tpu_torch.models.parity",
    "shodh_tpu_torch.models.trainer",
    "shodh_tpu_torch.models.contrastive",
    "shodh_tpu_torch.parallel.mesh",
    "shodh_tpu_torch.parallel.sharded_index",
    "shodh_tpu_torch.parallel.dryrun",
    "shodh_tpu_torch.index.kmeans",
    "shodh_tpu_torch.index.pq",
    "shodh_tpu_torch.index.ivf",
    "shodh_tpu_torch.index.backend",
    "shodh_tpu_torch.seat",
    "shodh_tpu_torch.seat.__main__",
    "shodh_tpu_torch.seat.conversation",
    "shodh_tpu_torch.seat.events",
    "shodh_tpu_torch.seat.ledger",
    "shodh_tpu_torch.seat.providers",
    "shodh_tpu_torch.seat.server",
    "shodh_tpu_torch.seat.store",
    "shodh_tpu_torch.nlp.appositive",
    "shodh_tpu_torch.nlp.catena",
    "shodh_tpu_torch.nlp.kb",
    "shodh_tpu_torch.nlp.relation_typer",
    "shodh_tpu_torch.nlp.yake",
    "shodh_tpu_torch.engine.learning_history",
    "tools.server_tour",
    "tools.client_tour",
    "tools.torch_slice_phases",
    "chip_smoke",
]
_ABSENT = ("jax", "shodh_tpu", "msgpack", "aiohttp")  # never imported by a port process
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+shodh_tpu(\.|\s*$|\s*,|\s+as\b)"
    r"|from\s+shodh_tpu(\.|\s+import\b))",
    re.M,
)


def _port_sources():
    files = sorted((ROOT / "shodh_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_profile_search.py",
        ROOT / "tools" / "torch_legs_ab.py", ROOT / "tools" / "torch_ingest_ab.py",
        ROOT / "tools" / "server_tour.py", ROOT / "tools" / "client_tour.py",
        ROOT / "tools" / "torch_server_rehearsal.py", ROOT / "tools" / "torch_slice_phases.py"]
    assert len(files) >= 10
    return files


def test_every_port_module_is_listed():
    """The subprocess check below imports every module of the package."""
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
             for p in (ROOT / "shodh_tpu_torch").rglob("*.py")}
    subpackages = {m for m in found if (ROOT / m.replace(".", "/") / "__init__.py").exists()}
    assert found - subpackages - {"shodh_tpu_torch"} <= set(PORT_MODULES)
    assert {"shodh_tpu_torch.storage", "shodh_tpu_torch.engine", "shodh_tpu_torch.nlp",
            "shodh_tpu_torch.models", "shodh_tpu_torch.utils", "shodh_tpu_torch.graph",
            "shodh_tpu_torch.retrieval", "shodh_tpu_torch.harness",
            "shodh_tpu_torch.server", "shodh_tpu_torch.clients",
            "shodh_tpu_torch.clients.tui", "shodh_tpu_torch.parallel",
            "shodh_tpu_torch.seat"} <= subpackages


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_ABSENT!r})\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def test_server_app_alone_imports_neither_jax_nor_aiohttp():
    """A fresh process that imports the port's server (as ``cli serve`` does)."""
    code = ("import sys\n"
            "import shodh_tpu_torch.server.app, shodh_tpu_torch.server.local_ipc\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_ABSENT!r})\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_seat_server_alone_imports_neither_jax_nor_aiohttp():
    """A fresh process that imports the port's seat server (as ``python -m
    shodh_tpu_torch.seat`` does): its HTTP layer is the port's own."""
    code = ("import sys\n"
            "import shodh_tpu_torch.seat.server\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_ABSENT!r})\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


_AIOHTTP = re.compile(r"^\s*(import|from)\s+aiohttp\b", re.M)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_source_has_no_aiohttp_import(path):
    assert not _AIOHTTP.findall(path.read_text()), path


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_source_has_no_reference_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "from jax import numpy", "import shodh_tpu",
                 "from shodh_tpu.ops import distance", "from shodh_tpu import constants",
                 "import shodh_tpu.ops"):
        assert _FORBIDDEN.search(line), line
    for line in ("import shodh_tpu_torch", "from shodh_tpu_torch.ops import distance"):
        assert not _FORBIDDEN.search(line), line
    assert _MSGPACK.search("import msgpack") and _MSGPACK.search("    from msgpack import packb")


_MSGPACK = re.compile(r"^\s*(import|from)\s+msgpack\b", re.M)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_source_has_no_msgpack_import(path):
    assert not _MSGPACK.findall(path.read_text()), path


def _port_names():
    return sorted(n for n in vars(port_constants) if n.isupper())


# names the JAX package keeps outside its constants module
_ELSEWHERE = {"FLAT_CONSENSUS": FLAT_CONSENSUS, "FLAT_CONSENSUS_NOTES": FLAT_CONSENSUS_NOTES,
              "DEEP_POOL_MULTIPLIER": DEEP_POOL_MULTIPLIER}


@pytest.mark.parametrize("name", _port_names())
def test_constants_equal_reference(name):
    want = _ELSEWHERE[name] if name in _ELSEWHERE else getattr(ref_constants, name)
    assert getattr(port_constants, name) == want


_CALL_TIME = ("disabled_boosts", "context_index_weight", "context_forward_weight",
              "context_index_weight2", "context_index_weight3", "context_forward_weight2",
              "recall_readonly", "prf_enabled", "prf_ungated", "prf_multihop",
              "prf_any_nontemporal", "semantic_adapt_enabled", "semantic_blend_weight")


@pytest.mark.parametrize("name", _CALL_TIME)
def test_call_time_knobs_equal_reference(name, monkeypatch):
    """The knobs read at call time, at their defaults and under overrides."""
    assert getattr(port_constants, name)() == getattr(ref_constants, name)()
    for var, value in (("SHODH_DISABLE_BOOSTS", " Speaker_Match, answer_type ,,"),
                       ("SHODH_CONTEXT_INDEX_WEIGHT", "0.5"), ("SHODH_CONTEXT_FWD_WEIGHT", "0"),
                       ("SHODH_CONTEXT_INDEX_WEIGHT2", "0.125"),
                       ("SHODH_CONTEXT_INDEX_WEIGHT3", "0.2"),
                       ("SHODH_CONTEXT_FWD_WEIGHT2", "0.3"), ("SHODH_RECALL_READONLY", "yes"),
                       ("SHODH_PRF", "0"), ("SHODH_PRF_UNGATED", "on"),
                       ("SHODH_PRF_MULTIHOP", "true"), ("SHODH_PRF_ANY_NONTEMPORAL", "off"),
                       ("SHODH_ADAPTIVE_SEMANTICS", "0"), ("SHODH_SEM_WEIGHT", "0.25")):
        monkeypatch.setenv(var, value)
    assert getattr(port_constants, name)() == getattr(ref_constants, name)()


def test_env_overrides_match_reference():
    code = (
        "from shodh_tpu_torch import constants as P\n"
        "from shodh_tpu import constants as R\n"
        f"for n in {_ENV_NAMES!r}:\n"
        "    assert getattr(P, n) == getattr(R, n), n\n"
        f"print(*(getattr(P, n) for n in {_ENV_NAMES!r}))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", **_ENV_OVERRIDES)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["0.25", "0.5", "0.125", "0.9", "0.4", "1.5", "0.6", "False",
                                  "True", "0.75", "0.2", "2", "7", "4", "0.45", "32", "0.25",
                                  "500", "5", "0.5", "6", "0.125"]


_ENV_NAMES = ("SPEAKER_MATCH_BOOST", "SEEK_TEMPORAL_REFS_BOOST", "ANSWER_TYPE_BOOST",
              "BM25_K1_DIALOGUE", "BM25_B_DIALOGUE", "BM25_K1_NOTES", "BM25_B_NOTES", "SPELLFIX",
              "GRAPH_PMI_GATE", "GRAPH_PMI_GATE_MIN", "TEMPORAL_SEEK_RECENCY_SCALE",
              "TEMPORAL_DIVERSITY_CAP", "PRF_TOP_DOCS", "PRF_TERMS", "PRF_TERM_WEIGHT",
              "SEMANTIC_REFIT_MIN_ABS", "SEMANTIC_REFIT_FRAC", "SEMANTIC_FIT_MAX_TEXTS",
              "SEM_EXPANSION_PER_STEM", "SEM_EXPANSION_MIN_SIM", "SEM_EXPANSION_MAX_TERMS",
              "SEM_EXPANSION_TERM_WEIGHT")
_ENV_OVERRIDES = dict(
    SHODH_SPEAKER_MATCH_BOOST="0.25", SHODH_SEEK_TREFS_BOOST="0.5",
    SHODH_ANSWER_TYPE_BOOST="0.125", SHODH_BM25_K1="0.9", SHODH_BM25_B="0.4",
    SHODH_BM25_K1_NOTES="1.5", SHODH_BM25_B_NOTES="0.6", SHODH_SPELLFIX="0",
    SHODH_GRAPH_PMI_GATE="1", SHODH_GRAPH_PMI_GATE_MIN="0.75", SHODH_SEEK_RECENCY_SCALE="0.2",
    SHODH_DIVERSITY_CAP="2", SHODH_PRF_TOP_DOCS="7", SHODH_PRF_TERMS="4", SHODH_PRF_WEIGHT="0.45",
    SHODH_SEM_REFIT_ABS="32", SHODH_SEM_REFIT_FRAC="0.25", SHODH_SEM_FIT_MAX_TEXTS="500",
    SHODH_SEM_EXP_PER_STEM="5", SHODH_SEM_EXP_MIN_SIM="0.5", SHODH_SEM_EXP_MAX_TERMS="6",
    SHODH_SEM_EXP_WEIGHT="0.125")


def test_precision_is_full_f32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_need_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert DeviceVectorIndex(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceVectorIndex(8)
    assert DeviceVectorIndex(8, device="cpu").device.type == "cpu"


def _client_entry_points(root):
    """Each entry point of the clients and of the model setup that opens an
    engine or an encoder, by name: a call with ``device`` as given."""
    from shodh_tpu_torch.clients.client import Memory
    from shodh_tpu_torch.clients.mcp_server import McpMemoryServer
    from shodh_tpu_torch.clients.tui import EngineData
    from shodh_tpu_torch.models.parity import minilm_geometry_parity

    return {
        "Memory(embedded=True)": lambda **kw: Memory(embedded=True, data_dir=str(root / "m"),
                                                     **kw).close(),
        "McpMemoryServer": lambda **kw: McpMemoryServer(root / "mcp", **kw).system.close(),
        "EngineData": lambda **kw: EngineData(str(root / "tui"), **kw).close(),
        "minilm_geometry_parity": lambda **kw: minilm_geometry_parity(root / "none", **kw),
    }


@pytest.mark.parametrize("name", ["Memory(embedded=True)", "McpMemoryServer", "EngineData",
                                  "minilm_geometry_parity"])
def test_client_entry_points_need_a_gpu_unless_given_cpu(tmp_path, monkeypatch, name):
    """(The parity's CPU run is ``tests/test_torch_model_setup.py``'s.)"""
    monkeypatch.setenv("HOME", str(tmp_path))  # no MiniLM checkpoint: the hash embedder
    call = _client_entry_points(tmp_path)[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    if name != "minilm_geometry_parity":
        call(device="cpu")


def test_chip_smoke_refuses_without_gpu():
    """Without a CUDA device the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
