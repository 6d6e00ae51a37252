"""The port's model setup (``shodh_tpu_torch/models/{downloader,parity}.py``
and ``cli setup-models``) against the JAX package's, with no network:
``ensure_minilm``'s offline refusal (``SHODH_OFFLINE``), its digest check
over a directory the test fills (a mismatch deletes the file), and its copy
from a ``file://`` base URL the test writes; the geometry parity against
transformers' ``BertModel`` (the oracle, on the CPU) on a checkpoint saved
from a randomly initialised two-layer ``BertModel`` with the reference
test's tiny vocabulary (``tests/test_models.py::TestMiniLMRealWeights``),
the port's encoder on the CPU; and ``setup-models``' exit codes and output,
equal to the JAX cli's."""

from __future__ import annotations

import contextlib
import hashlib
import io
import json

import pytest
import torch

import shodh_tpu.cli as ref_cli
import shodh_tpu.models.downloader as ref_dl
import shodh_tpu_torch.cli as port_cli
import shodh_tpu_torch.models.downloader as port_dl
from shodh_tpu_torch.models.parity import checkpoint_available, minilm_geometry_parity

MODULES = {"ref": ref_dl, "port": port_dl}
FILES = {"config.json": b'{"hidden_size": 384}\n', "vocab.txt": b"[PAD]\n[UNK]\nthe\n",
         "model.safetensors": bytes(range(256)) * 64}
TINY_VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the we to for a of on with use "
    "decided sqlite storage layer first deploy failed permissions "
    "error socket alice prefers reviewing pull requests in morning "
    "quarterly numbers revenue grew while churn stayed flat remind "
    "me rotate api credentials before friday robot lidar flagged an "
    "obstacle near waypoint seven how do transformers handle long "
    "range dependencies migration vector index finished without "
    "data loss ##s ##ed ##ing ##er 14 % . : ' ?"
).split()


def fill(d, files=FILES):
    d.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (d / name).write_bytes(data)
    return d


def digests(files=FILES) -> dict:
    return {name: hashlib.sha256(data).hexdigest() for name, data in files.items()}


def run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("value,offline", [("1", True), ("true", True), (" YES ", True),
                                           ("0", False), ("no", False), ("", False)])
def test_is_offline_reads_the_env_as_the_reference(monkeypatch, value, offline):
    monkeypatch.setenv("SHODH_OFFLINE", value)
    assert port_dl.is_offline() is ref_dl.is_offline() is offline


def test_offline_refuses_without_touching_the_network(tmp_path, monkeypatch):
    monkeypatch.setenv("SHODH_OFFLINE", "1")
    messages = {}
    for name, mod in MODULES.items():
        target = tmp_path / name
        with pytest.raises(mod.OfflineError) as exc:
            mod.ensure_minilm(target_dir=target, base_url="http://unreachable.invalid")
        messages[name] = str(exc.value).replace(str(target), "<t>")
        assert not target.exists()
    assert messages["port"] == messages["ref"]
    # the default target: the port's MiniLM directory under $HOME
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with pytest.raises(port_dl.OfflineError, match=str(tmp_path / "home" / ".cache")):
        port_dl.ensure_minilm()


def test_verify_present_checkpoint_and_delete_on_mismatch(tmp_path, monkeypatch):
    monkeypatch.setenv("SHODH_OFFLINE", "1")  # a present checkpoint needs no network
    errors = {}
    for name, mod in MODULES.items():
        target = fill(tmp_path / name)
        assert mod.ensure_minilm(target_dir=target, expected_sha256=digests()) == target
        assert mod.ensure_minilm(target_dir=target) == target  # no digests: no check
        bad = {**digests(), "vocab.txt": "0" * 64}
        with pytest.raises(ValueError) as exc:
            mod.ensure_minilm(target_dir=target, expected_sha256=bad)
        errors[name] = str(exc.value)
        assert not (target / "vocab.txt").exists() and (target / "config.json").exists()
    assert errors["port"] == errors["ref"]
    assert errors["port"].startswith("digest mismatch for vocab.txt: expected 000")


def test_download_from_a_file_url(tmp_path, monkeypatch):
    monkeypatch.delenv("SHODH_OFFLINE", raising=False)
    src = fill(tmp_path / "src")
    for name, mod in MODULES.items():
        target = tmp_path / name
        fill(target, {"config.json": FILES["config.json"]})  # present files are kept
        got = mod.ensure_minilm(target_dir=target, expected_sha256=digests(),
                                base_url=(src).as_uri())
        assert got == target
        assert {p.name: p.read_bytes() for p in target.iterdir()} == FILES


def test_setup_models_exit_codes_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("SHODH_OFFLINE", "1")
    outs = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        empty, ready = tmp_path / name / "empty", fill(tmp_path / name / "ready")
        offline = run(cli, ["setup-models", "--target-dir", str(empty), "--skip-parity"])
        skip = run(cli, ["setup-models", "--target-dir", str(ready), "--skip-parity"])
        outs[name] = [(rc, out.replace(str(tmp_path / name), "<t>"),
                       err.replace(str(tmp_path / name), "<t>")) for rc, out, err in (offline, skip)]
    assert outs["port"] == outs["ref"]
    (rc, _, err), (rc2, out2, _) = outs["port"]
    assert rc == 1 and err.startswith("offline: ") and rc2 == 0
    assert out2 == "checkpoint: <t>/ready\n"


def test_setup_models_needs_a_gpu_for_its_parity(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("SHODH_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(port_cli, ["setup-models", "--target-dir", str(fill(tmp_path / "c"))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minilm_geometry_parity(tmp_path / "c")


# ---------------------------------------------------------------------------
# The geometry parity on a synthetic checkpoint
# ---------------------------------------------------------------------------


def save_bert(dest, hidden: int, heads: int, ffn: int, layers: int = 2):
    """A randomly initialised ``BertModel`` saved as transformers saves one
    (``config.json``, ``model.safetensors``), with the tiny vocabulary."""
    from transformers import BertConfig, BertModel

    cfg = BertConfig(vocab_size=len(TINY_VOCAB), hidden_size=hidden, num_hidden_layers=layers,
                     num_attention_heads=heads, intermediate_size=ffn,
                     max_position_embeddings=128)
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "vocab.txt").write_text("\n".join(TINY_VOCAB) + "\n")
    torch.manual_seed(0)
    BertModel(cfg).eval().save_pretrained(dest)
    return dest


@pytest.fixture()
def no_tensorflow(monkeypatch):
    # transformers then imports neither TensorFlow nor Flax (about 10 s less)
    for var, value in (("USE_TF", "0"), ("USE_FLAX", "0"), ("USE_TORCH", "1")):
        monkeypatch.setenv(var, value)


def test_geometry_parity_on_a_small_synthetic_checkpoint(tmp_path, no_tensorflow):
    """The setup-models parity path (safetensors written by transformers,
    config adaptation, the tokenizer against ``BertTokenizerFast``, the
    oracle's recipe) at a width of 48 (MiniLM's 6 heads of 8), through
    ``cli setup-models --cpu``."""
    ckpt = save_bert(tmp_path / "ckpt", hidden=48, heads=6, ffn=96)
    assert checkpoint_available(ckpt)
    report = minilm_geometry_parity(ckpt, device="cpu")
    assert report["pass"] and report["f32"]["min_cosine"] > 0.99999, report
    assert report["int8"]["min_cosine"] > 0.999, report
    rc, out, err = run(port_cli, ["setup-models", "--target-dir", str(ckpt), "--cpu"])
    assert rc == 0, err
    assert out.startswith(f"checkpoint: {ckpt}\n")
    assert out.rstrip().endswith("geometry parity OK — MiniLM is now the default embedder")
    assert json.loads(out[out.index("{"):out.rindex("}") + 1]) == report


@pytest.mark.slow
def test_geometry_parity_on_a_synthetic_checkpoint_equals_the_reference(tmp_path,
                                                                        no_tensorflow):
    """At MiniLM's published width (two layers), as the reference's own test;
    the port's report equals the JAX package's."""
    from shodh_tpu.models.parity import minilm_geometry_parity as ref_parity
    from shodh_tpu_torch.models.minilm import CONFIG

    ckpt = save_bert(tmp_path, hidden=CONFIG["hidden"], heads=CONFIG["heads"],
                     ffn=CONFIG["ffn"])
    report = minilm_geometry_parity(ckpt, device="cpu")
    assert report["pass"], report
    want = ref_parity(ckpt)
    assert report["pass"] == want["pass"] and report["n_texts"] == want["n_texts"]
    for mode in ("f32", "int8"):
        for key in ("min_cosine", "mean_cosine"):
            assert report[mode][key] == pytest.approx(want[mode][key], abs=1e-6)
