"""The port's recall harness and ``python -m shodh_tpu_torch.cli eval``
against the JAX package's ``python -m shodh_tpu.cli eval``.

Both run the ``smoke`` and ``locomo-gate`` suites over the whole layer
ladder, with the device funnel on (the default) and off
(``SHODH_DEVICE_FUNNEL=0``), each in a process of its own under
``PYTHONHASHSEED=0`` (rankings can follow the string hash seed, ROADMAP.md
section 3, R12); the port runs with ``--device cpu``. Their ``--dump``
files must be equal byte for byte, the port's process must hold neither
``jax`` nor ``shodh_tpu`` in ``sys.modules``, and the reference's dumps
must equal the ones committed under ``tests/torch_eval_dumps/``, which
``chip_smoke.py`` holds the card's eval to (the card's machine has no JAX).
``--baseline``/``--tolerance`` give the reference's exit codes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DUMPS = ROOT / "tests" / "torch_eval_dumps"
LADDER = "vector_only,+spreading,+bm25,+rerank,+facts,full"
SUITES = ("smoke", "locomo-gate")

# Runs the port's cli as ``python -m`` would, then fails if a module of JAX
# or of the JAX package was imported
_PORT = """
import runpy, sys
sys.argv = ["shodh_tpu_torch.cli", *sys.argv[1:]]
try:
    runpy.run_module("shodh_tpu_torch.cli", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "shodh_tpu"))
assert not bad, bad
sys.exit(code)
"""


def eval_args(suite: str, dump) -> list[str]:
    return ["eval", "--suite", suite, "--layers", LADDER, "--dump", str(dump)]


def run_both(tmp_path, suite: str, extra_env: dict) -> tuple[bytes, bytes]:
    """Both packages' eval of ``suite`` in two processes at once; returns the
    (port, reference) dumps."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONHASHSEED="0", **extra_env)
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    procs = [
        subprocess.Popen([sys.executable, "-c", _PORT, *eval_args(suite, port), "--device",
                          "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
        subprocess.Popen([sys.executable, "-m", "shodh_tpu.cli", *eval_args(suite, ref)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True),
    ]
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return port.read_bytes(), ref.read_bytes()


@pytest.mark.parametrize("funnel", ["device_funnel", "staged"])
@pytest.mark.parametrize("suite", SUITES)
def test_eval_dump_equals_reference(tmp_path, suite, funnel):
    extra = {"SHODH_DEVICE_FUNNEL": "0"} if funnel == "staged" else {}
    got, want = run_both(tmp_path, suite, extra)
    assert got == want
    report = json.loads(got)
    assert report["suite"] == suite and list(report["layers"]) == sorted(LADDER.split(","))
    assert all(not k.startswith("latency_") for layer in report["layers"].values() for k in layer)
    assert report["layers"]["full"]["recall@10"] > report["layers"]["vector_only"]["recall@10"]
    if funnel == "device_funnel":
        # the committed dumps that the card's eval is held to
        assert (DUMPS / f"{suite}.json").read_bytes() == want


@pytest.mark.parametrize("baseline", ["easy", "hard", "committed"])
def test_eval_baseline_exit_codes_equal_reference(tmp_path, capsys, baseline):
    """The exit code of ``--baseline`` (0 on a pass, 1 on a regression beyond
    ``--tolerance``) and the diff it prints are the reference's."""
    from shodh_tpu.cli import main as ref_main
    from shodh_tpu_torch.cli import main as port_main

    path = {"committed": ROOT / "tests" / "recall" / "baseline.json"}.get(baseline)
    if path is None:
        path = tmp_path / f"{baseline}.json"
        floor = {"easy": {"recall@10": 0.1, "p@1": 0.1}, "hard": {"recall@10": 1.5}}[baseline]
        path.write_text(json.dumps({"layers": {"full": floor}}))
    args = ["eval", "--corpus", "tests/recall/corpora/shodh-smoke.jsonl",
            "--cases", "tests/recall/smoke_cases.jsonl", "--eval-now", "2026-05-01T00:00:00Z",
            "--baseline", str(path), "--tolerance", "0.02"]
    cwd = os.getcwd()
    try:
        os.chdir(ROOT)
        got = port_main(args + ["--device", "cpu"])
        got_diff = capsys.readouterr().err
        want = ref_main(args)
        want_diff = capsys.readouterr().err
    finally:
        os.chdir(cwd)
    assert got == want == {"easy": 0, "hard": 1, "committed": want}[baseline]
    assert got_diff == want_diff and json.loads(got_diff)


def test_chip_smoke_eval_phase_on_the_cpu(tmp_path):
    """The chip script's ``eval`` phase on the CPU for the smoke suite: its
    dump equals the committed one, and it reports every layer's latency."""
    import chip_smoke as cs

    rec = cs.phase_eval(tmp_path, device="cpu", suites=("smoke",))
    smoke = rec["suites"]["smoke"]
    assert rec["phase"] == "eval" and smoke["cases"] == 108
    assert set(smoke["latency_ms"]) == set(LADDER.split(","))
    assert smoke["full"] == {m: json.loads((DUMPS / "smoke.json").read_text())["layers"]["full"][m]
                             for m in smoke["full"]}
