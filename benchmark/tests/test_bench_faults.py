"""A run at a size the CPU holds, with the chip's look skipped: sound, it
comes out correct; with the timed path broken underneath, not correct, once
for each fault these cells can have (one chip, so no exchange between chips
to leave out)."""

from __future__ import annotations

import time

import numpy as np
import pytest

import bench_tiny
from benchlib import cell as cell_mod
from shodh_tpu_torch.index.device_index import DeviceVectorIndex
from shodh_tpu_torch.models.embedder import MiniLMEmbedder
from shodh_tpu_torch.models.tokenizer import WordPieceTokenizer


def test_sound_query_run_is_correct():
    line, run = bench_tiny.run_tiny("nq-f32.query-b256")
    assert line["correct"], line["checks"]
    assert line["attempted"] == run.items > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"queries_per_s", "search_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"


def test_sound_traced_ingest_run_is_correct():
    line, _ = bench_tiny.run_tiny("msmarco-int8.ingest-b256", traced=True)
    assert line["correct"], line["checks"]
    assert {"embed_ms.ingest", "append_ms.ingest",
            "padded_token_share.ingest"} <= set(line["metrics"])
    assert line["checks"]["append_err"]["value"] <= 0.5 + 1e-3


def altered_answer(monkeypatch):
    """Each call's last query gets a wrong top row."""
    search = DeviceVectorIndex.search

    def wrong(self, queries, k):
        vals, rows = search(self, queries, k)
        rows = rows.copy()
        rows[-1, 0] = (rows[-1, 0] + 7) % len(self)
        return vals, rows

    monkeypatch.setattr(DeviceVectorIndex, "search", wrong)


def altered_token(monkeypatch):
    """Every text's first word piece is another."""
    encode = WordPieceTokenizer.encode

    def wrong(self, text, max_len=256):
        ids = encode(self, text, max_len)
        return [ids[0], (ids[1] + 1) % len(self.vocab)] + ids[2:]

    monkeypatch.setattr(WordPieceTokenizer, "encode", wrong)


def half_batch(monkeypatch):
    """Only the first half of a batch is encoded; the rest get its mean."""
    encode_batch = MiniLMEmbedder.encode_batch

    def half(self, texts):
        if len(texts) < 2:
            return encode_batch(self, texts)
        out = encode_batch(self, texts[: len(texts) // 2])
        mean = out.mean(axis=0)
        rest = np.repeat((mean / np.linalg.norm(mean))[None], len(texts) - len(out), axis=0)
        return np.concatenate([out, rest]).astype(np.float32)

    monkeypatch.setattr(MiniLMEmbedder, "encode_batch", half)


def unchanged_state(monkeypatch):
    """flush leaves the appended rows as they were before the append."""
    flush = DeviceVectorIndex.flush

    def stale(self):
        start = self._count - self._pending_rows
        flush(self)
        self._vecs_np[start:self._count] = 0

    monkeypatch.setattr(DeviceVectorIndex, "flush", stale)


@pytest.mark.parametrize("workload,fault,caught", [
    ("nq-f32.query-b256", altered_answer, "rank_gap"),
    ("msmarco-int8.query-b256", altered_token, "token_mismatch"),
    ("nq-f32.query-b256", half_batch, "embed_max_abs"),
    ("msmarco-int8.ingest-b256", unchanged_state, "append_err"),
    ("msmarco-int8.ingest-b256", altered_token, "token_mismatch"),
])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault, caught):
    fault(monkeypatch)
    line, _ = bench_tiny.run_tiny(workload)
    assert not line["correct"]
    c = line["checks"][caught]
    assert c["value"] > c["limit"], line["checks"]


def sub_batched(monkeypatch):
    """encode_batch pads and encodes each call's texts in two batches."""
    encode_batch = MiniLMEmbedder.encode_batch

    def twice(self, texts):
        if len(texts) < 2:
            return encode_batch(self, texts)
        half = len(texts) // 2
        return np.concatenate([encode_batch(self, texts[:half]), encode_batch(self, texts[half:])])

    monkeypatch.setattr(MiniLMEmbedder, "encode_batch", twice)


def renamed_padded_entry(monkeypatch):
    """The embedder encodes its padded batches under another name."""
    encode_padded = MiniLMEmbedder.encode_padded

    def encode_batch(self, texts):
        out = encode_padded(self, *self.pad_batch(texts))
        return out[: len(texts)].cpu().numpy()

    monkeypatch.delattr(MiniLMEmbedder, "encode_padded")
    monkeypatch.setattr(MiniLMEmbedder, "encode_batch", encode_batch)


@pytest.mark.parametrize("hide", [sub_batched, renamed_padded_entry])
def test_unread_padded_batches_fail_the_token_check(monkeypatch, hide):
    hide(monkeypatch)
    line, run = bench_tiny.run_tiny("nq-f32.query-b256")
    assert not line["correct"]
    assert line["checks"]["token_mismatch"]["value"] == len(run.served_texts) > 0


def test_traced_ingest_without_padded_batches_fails(monkeypatch):
    renamed_padded_entry(monkeypatch)
    with pytest.raises(RuntimeError, match="padded_token_share"):
        bench_tiny.run_tiny("msmarco-int8.ingest-b256", traced=True)


def test_a_short_first_pool_is_extended_from_the_warm_up(monkeypatch):
    spec, cell, config, traffic = bench_tiny.tiny("nq-f32.query-b1")
    traffic.update(pool_items_per_s=1)
    monkeypatch.setattr(cell_mod, "POOL_MARGIN", 20.0)  # the CPU's warm-up is slow
    run, checks, failed, _ = cell_mod.run_cell(cell, config, traffic, 2**31 + 11, 1.0, False,
                                               "cpu", time.perf_counter())
    assert failed == 0 and run.items > 1
    assert all(value <= limit for value, limit in checks.values()), checks


def test_a_window_that_runs_out_of_texts_fails(monkeypatch):
    spec, cell, config, traffic = bench_tiny.tiny("nq-f32.query-b1")
    traffic.update(pool_items_per_s=1)
    monkeypatch.setattr(cell_mod, "POOL_MARGIN", 0.0)
    with pytest.raises(RuntimeError, match="ran out"):
        cell_mod.run_cell(cell, config, traffic, 2**31 + 11, 1.0, False, "cpu",
                          time.perf_counter())
