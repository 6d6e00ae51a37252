"""One run of one cell: set-up, the measured window, the check.

The system under test is the program's own entry: the embedder that the
configuration's encoder family makes through the program's normal entry
(over weights the set-up draws from the seed and files it writes under
``TMPDIR``) and a ``DeviceVectorIndex`` of the configuration's dtype. A
query call is ``encode_batch(texts)`` then ``search(vectors, k)``; an
ingest call is ``encode_batch(passages)``, ``add(vectors)``, ``flush()``.
One client, closed loop: each call starts when the previous one returns.
Every text of a run is distinct and made in set-up: a first pool sized by
the traffic's ``pool_items_per_s``, then, where the warm-up's fastest call
says that the window could use more, further chunks from the seed. A window
that still runs out of texts fails the run.
"""

from __future__ import annotations

import contextlib
import gc
import math
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchlib import check, inputs, textgen
from benchlib import spec as spec_mod
from benchlib import trace as trace_mod

# Window texts made at the least: this many times what the warm-up's fastest
# call would take through the window.
POOL_MARGIN = 2.0


@dataclass
class Call:
    start: float
    embedded: float  # encode_batch returned
    end: float
    items: int


@dataclass
class Run:
    """What a metric's reader reads."""

    kind: str  # "query" or "ingest"
    config: dict
    traffic: dict
    setup_s: float
    calls: list = field(default_factory=list)
    window_s: float = 0.0
    real_tokens: int | None = None  # counted by the family's probe on the embedder
    padded_tokens: int | None = None
    trace: trace_mod.Trace | None = None
    served_texts: list = field(default_factory=list)
    family: object = None  # the configuration's encoder family module
    reference: object = None  # the family's reference, made once the window has closed
    _ref_lengths: list | None = None

    @property
    def items(self) -> int:
        return sum(c.items for c in self.calls)

    def ref_lengths(self) -> list[int]:
        """Token count of every served text by the reference tokenizer."""
        if self._ref_lengths is None:
            self._ref_lengths = [len(ids) for ids in self.reference.token_ids(self.served_texts)]
        return self._ref_lengths


class Steps:
    """Seconds of each set-up step since the last, on standard error."""

    def __init__(self, t_start: float):
        self.t = t_start

    def done(self, what: str) -> None:
        now = time.perf_counter()
        print(f"bench: set-up {what} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def _maker(config: dict, spec: dict) -> textgen.TextMaker:
    family = spec_mod.family(config["model"]["family"])
    return textgen.TextMaker(family.words(config["model"]), family.SUFFIXES,
                             {**config["texts"]["words"], **spec})


def text_pool(config: dict, traffic: dict, seed: int, n_window: int, n_warm: int):
    """(warm-up texts, window texts), all distinct; call 0 of the warm-up
    has the window pool's longest word counts, so its largest shape is
    warm."""
    spec = config["texts"][traffic["text"]]
    rng = np.random.default_rng(inputs.stream_seed(seed, "texts"))
    counts = textgen.word_counts(n_window, spec["mean_words"], spec["sigma"], rng)
    b = traffic["batch"]
    warm = np.concatenate([np.sort(counts)[-b:],
                           rng.choice(counts, max(0, n_warm - b), replace=False)])
    texts = _maker(config, spec).texts(np.concatenate([warm, counts]), rng)
    return texts[:len(warm)], texts[len(warm):]


def more_texts(config: dict, traffic: dict, seed: int, n: int, chunk: int, seen: set) -> list[str]:
    """Chunk ``chunk`` of further window texts: ``n`` texts with the word
    counts of a pool of ``n``, from a stream of their own, distinct from
    ``seen`` (which takes them in). The same seed gives the same chunks, so
    the window's texts are one sequence whatever number of chunks is made."""
    spec = config["texts"][traffic["text"]]
    rng = np.random.default_rng(inputs.stream_seed(seed, f"texts.{chunk}"))
    counts = textgen.word_counts(n, spec["mean_words"], spec["sigma"], rng)
    return _maker(config, spec).texts(counts, rng, seen)


def _index(config: dict, seed: int, device, empty: bool):
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex

    idx = config["index"]
    if empty:
        return DeviceVectorIndex(dim=idx["dim"], dtype=idx["dtype"], device=device)
    rows, scales = inputs.host_rows(seed, idx["rows"], idx["dim"], idx["dtype"], device)
    index = DeviceVectorIndex.from_numpy(rows, scales, np.ones(len(rows), np.float32),
                                         count=len(rows), device=device)
    del rows, scales
    return index


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             traced: bool, device, t_start: float):
    """Set up, measure, check. Returns (Run, checks, failed items, memory
    peak bytes); ``checks`` maps each compared number to (value, limit)."""
    if torch.device(device).type == "cuda":
        torch.cuda.init()
    kind, b = traffic["kind"], traffic["batch"]
    model = config["model"]
    family = spec_mod.family(model["family"])
    k = config["index"]["k"]
    n_window = math.ceil(traffic["pool_items_per_s"] * seconds / b) * b
    steps = Steps(t_start)
    steps.done("start")
    warm_texts, texts = text_pool(config, traffic, seed, n_window, traffic["warmup_calls"] * b)
    steps.done("texts")
    weights = family.weights(seed, model, device)
    workdir = Path(tempfile.mkdtemp(prefix="bench-encoder-"))
    try:
        steps.done("weights")
        embedder = family.embedder(workdir, weights, model, device)
        probe = family.Probe(embedder)
        steps.done("embedder")
        index = _index(config, seed, device, empty=kind == "ingest")
        steps.done("index")

        span = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
        second = "bench.search" if kind == "query" else "bench.append"

        def call(target, batch):
            """One call: (vectors, the moment encode_batch returned, answer)."""
            with span("bench.embed"):
                vecs = embedder.encode_batch(batch)
            mid = time.perf_counter()
            with span(second):
                if kind == "query":
                    return vecs, mid, target.search(vecs, k)
                rows = target.add(vecs)
                target.flush()
                return vecs, mid, rows

        warm_index = _index(config, seed, device, empty=True) if kind == "ingest" else index
        fastest = math.inf
        for i in range(traffic["warmup_calls"]):
            t = time.perf_counter()
            call(warm_index, warm_texts[i * b:(i + 1) * b])
            _sync(device)
            fastest = min(fastest, time.perf_counter() - t)
        del warm_index
        steps.done("warm-up")
        need = math.ceil(POOL_MARGIN * seconds / fastest) * b
        if need > len(texts):
            seen = set(warm_texts) | set(texts)
            chunk = 0
            while len(texts) < need:
                texts += more_texts(config, traffic, seed, n_window, chunk, seen)
                chunk += 1
            del seen
            steps.done(f"more texts ({chunk} chunks)")
        probe.clear()
        gc.collect()
        gc.freeze()
        run = Run(kind=kind, config=config, traffic=traffic,
                  setup_s=time.perf_counter() - t_start, family=family)

        outputs = []
        failed = 0
        ran_out = False
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities) if traced else contextlib.nullcontext()
        with prof, span("bench.window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                i = len(run.calls)
                if (i + 1) * b > len(texts):
                    ran_out = True
                    break
                start = time.perf_counter()
                try:
                    vecs, mid, out = call(index, texts[i * b:(i + 1) * b])
                except Exception:  # noqa: BLE001 - a failed call is counted and ends the window
                    traceback.print_exc()
                    failed += b
                    break
                run.calls.append(Call(start, mid, time.perf_counter(), b))
                outputs.append((vecs, out))
            run.window_s = (run.calls[-1].end if run.calls else time.perf_counter()) - t0
        gc.unfreeze()
        if ran_out:
            raise RuntimeError(f"the window's {len(texts)} texts ran out after {len(run.calls)} "
                               f"calls, {run.window_s:.3f} s into a {seconds} s window")
        peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
        run.served_texts = texts[:len(run.calls) * b]
        tokens = probe.tokens()
        if tokens is not None:
            run.real_tokens, run.padded_tokens = tokens
        if traced:
            run.trace = trace_mod.read(prof)

        picks = check.sample(len(run.served_texts), [len(t) for t in run.served_texts],
                             traffic["check_random"], traffic["check_longest"], seed)
        served = _served(picks, run, outputs, probe, index, kind, b)
        del outputs, index, embedder, probe
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        run.reference = family.Reference(model, weights, device)
        ref = check.Reference(config, run.reference, seed, device)
        values = check.numbers(served, ref, kind) if picks else {}
        checks = {name: (value, config["limits"][name]) for name, value in values.items()}
        return run, checks, failed, peak
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _served(picks, run, outputs, probe, index, kind, b) -> check.Served:
    """The timed path's outputs for the sampled texts."""
    calls = [p // b for p in picks]
    served = check.Served(texts=[run.served_texts[p] for p in picks],
                          vectors=np.stack([outputs[c][0][p % b] for p, c in zip(picks, calls)]))
    # a text whose ids the probe cannot tell (None) counts as a token mismatch
    ids = probe.token_ids(len(outputs), b)
    served.token_ids = [ids(c, p % b) if ids else None for p, c in zip(picks, calls)]
    if kind == "query":
        served.scores = np.stack([outputs[c][1][0][p % b] for p, c in zip(picks, calls)])
        served.rows = np.stack([outputs[c][1][1][p % b] for p, c in zip(picks, calls)])
    else:
        assigned = [r for _, rows in outputs for r in rows]
        served.missing_rows = (abs(len(index) - len(assigned))
                               + sum(r != i for i, r in enumerate(assigned)))
        rows = np.asarray([outputs[c][1][p % b] for p, c in zip(picks, calls)])
        inside = (rows >= 0) & (rows < len(index))
        served.missing_rows += int((~inside).sum())
        served.stored = np.zeros((len(rows), index.dim), np.float32)
        try:
            served.stored[inside] = index.get_vectors(rows[inside])
        except Exception:  # noqa: BLE001 - rows the index cannot read back are missing
            traceback.print_exc()
            served.missing_rows += int(inside.sum())
    return served
