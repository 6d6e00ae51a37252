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
from shodh_tpu.retrieval.fusion import FLAT_CONSENSUS
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
    "shodh_tpu_torch.nlp.normalize",
    "shodh_tpu_torch.nlp.norms",
    "shodh_tpu_torch.nlp.lemmas",
    "shodh_tpu_torch.nlp.stemmer",
    "shodh_tpu_torch.models.hash_embedder",
    "shodh_tpu_torch.models.embedder",
    "chip_smoke",
]
_ABSENT = ("jax", "shodh_tpu", "msgpack")  # never imported by a port process
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+shodh_tpu(\.|\s*$|\s*,|\s+as\b)"
    r"|from\s+shodh_tpu(\.|\s+import\b))",
    re.M,
)


def _port_sources():
    files = sorted((ROOT / "shodh_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_profile_search.py"]
    assert len(files) >= 10
    return files


def test_every_port_module_is_listed():
    """The subprocess check below imports every module of the package."""
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
             for p in (ROOT / "shodh_tpu_torch").rglob("*.py")}
    subpackages = {m for m in found if (ROOT / m.replace(".", "/") / "__init__.py").exists()}
    assert found - subpackages - {"shodh_tpu_torch"} <= set(PORT_MODULES)
    assert {"shodh_tpu_torch.storage", "shodh_tpu_torch.engine", "shodh_tpu_torch.nlp",
            "shodh_tpu_torch.models", "shodh_tpu_torch.utils"} <= subpackages


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


@pytest.mark.parametrize("name", _port_names())
def test_constants_equal_reference(name):
    want = FLAT_CONSENSUS if name == "FLAT_CONSENSUS" else getattr(ref_constants, name)
    assert getattr(port_constants, name) == want


def test_env_overrides_match_reference():
    code = (
        "from shodh_tpu_torch import constants as P\n"
        "from shodh_tpu import constants as R\n"
        "for n in ('SPEAKER_MATCH_BOOST', 'SEEK_TEMPORAL_REFS_BOOST', 'ANSWER_TYPE_BOOST'):\n"
        "    assert getattr(P, n) == getattr(R, n), n\n"
        "print(P.SPEAKER_MATCH_BOOST, P.SEEK_TEMPORAL_REFS_BOOST, P.ANSWER_TYPE_BOOST)\n"
    )
    env = dict(os.environ, SHODH_SPEAKER_MATCH_BOOST="0.25", SHODH_SEEK_TREFS_BOOST="0.5",
               SHODH_ANSWER_TYPE_BOOST="0.125", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["0.25", "0.5", "0.125"]


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


def test_chip_smoke_refuses_without_gpu():
    """Without a CUDA device the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
