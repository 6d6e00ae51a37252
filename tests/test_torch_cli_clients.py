"""The port's command line against the JAX package's: the same subcommands,
and the scaffolding ones (``init``, ``setup-hooks``, ``doctor``,
``version``) printing what the reference prints but for the wanted
differences (``ROADMAP.md`` section 3): ``init`` names the port's module in
its ``serve with:`` line, and ``doctor`` prints torch, CUDA and the CUDA
devices where the reference prints JAX's backend and devices, and exits 1
without a GPU unless ``--cpu``. Mirrors ``tests/test_mcp.py::
TestCliScaffolding``. (The client subcommands' stdout is held to the
reference's in ``tests/test_torch_client.py``.)"""

from __future__ import annotations

import contextlib
import io
import json
import re

import pytest
import torch

import shodh_tpu.cli as ref_cli
import shodh_tpu_torch.cli as port_cli


def run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def subcommands(cli) -> set[str]:
    """The subcommand names from the usage line that ``main([])`` prints."""
    rc, out, _ = run(cli, [])
    assert rc == 1
    return set(re.search(r"\{([a-z,-]+)\}", out).group(1).split(","))


def test_every_reference_subcommand_has_its_counterpart():
    ref, port = subcommands(ref_cli), subcommands(port_cli)
    assert port == ref, (sorted(ref - port), sorted(port - ref))
    assert {"remember", "recall", "stats", "status", "maintenance", "init", "setup-hooks",
            "doctor", "version", "setup-models"} <= port


def test_init_is_idempotent_and_prints_as_the_reference(tmp_path):
    """Twice over one directory: the same key, the reference's lines, the
    port's module in the ``serve with:`` line (the one wanted difference)."""
    outs = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        d = tmp_path / name / "d"
        first = run(cli, ["init", "--data-dir", str(d)])
        second = run(cli, ["init", "--data-dir", str(d)])
        assert first[0] == second[0] == 0
        key = first[1].split("api key: ")[1].split()[0]
        assert key.startswith("sk-shodh-") and second[1].split("api key: ")[1].split()[0] == key
        assert "already initialized" in second[1]
        assert json.loads((d / "credentials.json").read_text()) == {"api_key": key}
        assert (d / "credentials.json").stat().st_mode & 0o777 == 0o600
        outs[name] = [o.replace(str(d), "<d>").replace(key, "<key>")
                      for o in (first[1], second[1])]
    for got, want in zip(outs["port"], outs["ref"]):
        assert got == want.replace("python -m shodh_tpu.cli serve",
                                   "python -m shodh_tpu_torch.cli serve")
    assert "python -m shodh_tpu_torch.cli serve --data-dir <d>" in outs["port"][0]


def test_setup_hooks_merges_settings_as_the_reference(tmp_path):
    results = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        proj = tmp_path / name / "proj"
        (proj / ".claude").mkdir(parents=True)
        (proj / ".claude" / "settings.json").write_text(
            json.dumps({"hooks": {"PreToolUse": [{"hooks": []}]}, "other": 1}))
        rc, out, _ = run(cli, ["setup-hooks", "--project", str(proj)])
        assert rc == 0
        settings = json.loads((proj / ".claude" / "settings.json").read_text())
        assert "SessionStart" in settings["hooks"] and "PreToolUse" in settings["hooks"]
        assert settings["other"] == 1 and (proj / "hooks" / "stop.sh").exists()
        results[name] = (out.replace(str(proj), "<proj>"), settings,
                         sorted(p.name for p in (proj / "hooks").iterdir()),
                         [(proj / "hooks" / f).read_bytes() for f in ("session_start.sh",
                                                                      "user_prompt.sh",
                                                                      "stop.sh")])
    assert results["port"] == results["ref"]


def test_version_prints_as_the_reference():
    assert run(port_cli, ["version"]) == run(ref_cli, ["version"]) == (0, "0.1.0\n", "")


def test_doctor_prints_as_the_reference_on_the_cpu(monkeypatch, tmp_path):
    """``doctor --cpu``: the Python and embedder lines equal the reference's
    (no MiniLM checkpoint: the hash embedder); torch, CUDA and the devices
    take the place of JAX's lines."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("SHODH_MINILM_DIR", raising=False)
    rc, out, _ = run(port_cli, ["doctor", "--cpu"])
    ref_rc, ref_out, _ = run(ref_cli, ["doctor"])
    assert rc == ref_rc == 0
    lines, ref_lines = out.splitlines(), ref_out.splitlines()
    assert [lines[0], lines[-1]] == [ref_lines[0], ref_lines[-1]]
    assert ref_lines[-1] == "embedder: hash-projection-v1 (dim 384)"
    assert lines[1] == f"torch: {torch.__version__}, cuda: {torch.version.cuda}"
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    assert lines[2] == (f"devices: {names}" if names else "devices: none (no CUDA device)")
    assert len(lines) == len(ref_lines) == 4


def test_doctor_without_a_gpu_exits_1(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("HOME", str(tmp_path))
    rc, out, err = run(port_cli, ["doctor"])
    assert rc == 1 and "embedder" not in out
    assert out.splitlines()[-1] == "devices: none (no CUDA device)"
    assert "no CUDA device" in err


def test_device_flags_conflict():
    with pytest.raises(SystemExit):
        run(port_cli, ["doctor", "--cpu", "--device", "cuda"])
