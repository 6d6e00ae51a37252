"""The port's own copies of the JAX package's host modules that the engine
reads (types, clock, hashing, geohash, L5 scoring, feedback) give the
reference's results on the same inputs."""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from shodh_tpu import types as ref_types
from shodh_tpu.engine import feedback as ref_feedback
from shodh_tpu.engine import scoring as ref_scoring
from shodh_tpu.storage.kv import KvStore as RefKv
from shodh_tpu.utils import clock as ref_clock
from shodh_tpu.utils import geohash as ref_geohash
from shodh_tpu.utils import hashing as ref_hashing
from shodh_tpu_torch import types
from shodh_tpu_torch.engine import feedback, scoring
from shodh_tpu_torch.storage.kv import KvStore
from shodh_tpu_torch.utils import clock, geohash, hashing

NOW = datetime(2025, 2, 3, 4, 5, 6, tzinfo=timezone.utc)


def test_types_round_trip_like_reference():
    d = {"content": "Ana: went to Porto", "experience_type": "Decision", "tags": ["a", "B"],
         "entities": ["Ana"], "metadata": {"k": "v"}, "geo_location": [41.1, -8.6],
         "local_position": [1, 2, 3], "emotional": {"arousal": 0.4, "valence": -0.2},
         "source": {"credibility": 0.9, "origin": "chat"}, "reward": 0.5, "anomaly": True,
         "temporal_refs": ["2025-02-01"], "toponyms": ["Porto"], "session_id": "s"}
    exp, ref_exp = types.Experience.from_dict(d), ref_types.Experience.from_dict(d)
    assert exp.to_dict() == ref_exp.to_dict()
    mem = types.Memory(id="m1", experience=exp, created_at=NOW, importance=0.7,
                       last_accessed=NOW, tier=types.MemoryTier.SESSION, vector_row=3)
    ref_mem = ref_types.Memory.from_dict(mem.to_dict())
    assert types.Memory.from_dict(ref_mem.to_dict()).to_dict() == ref_mem.to_dict()
    assert types.Experience(content="x", experience_type="nonsense").experience_type == \
        ref_types.Experience(content="x", experience_type="nonsense").experience_type.value
    q = {"query": "where", "limit": 4, "time_range": ["2025-01-01T00:00:00Z", 1.7e9],
         "layers": "plus_bm25", "retrieval_mode": "Temporal", "geo_filter": {"lat": 1, "lon": 2}}
    got, want = types.Query.from_dict(q), ref_types.Query.from_dict(q)
    assert (got.query_text, got.max_results, got.time_range, int(got.layers), got.retrieval_mode.value,
            got.geo_filter.radius_m) == (want.query_text, want.max_results, want.time_range,
                                         int(want.layers), want.retrieval_mode.value,
                                         want.geo_filter.radius_m)
    for v in ("2024-05-06T07:08:09Z", "2024-05-06T07:08:09+02:00", "2024-05-06T07:08:09", 1.5e9):
        assert types.parse_ts(v) == ref_types.parse_ts(v)
        assert types.format_ts(types.parse_ts(v)) == ref_types.format_ts(ref_types.parse_ts(v))
    assert types.deterministic_memory_id("h", NOW) == ref_types.deterministic_memory_id("h", NOW)
    with pytest.raises(ValueError):
        types.LayerMode.parse("bogus")


def test_clock_and_hashing(monkeypatch):
    monkeypatch.setenv("SHODH_EVAL_NOW", "2024-01-02T03:04:05Z")
    assert clock.scoring_now() == ref_clock.scoring_now()
    clock.pin_now(NOW)
    try:
        assert clock.scoring_now() == NOW
    finally:
        clock.pin_now(None)
    later = NOW + timedelta(hours=30)
    assert clock.hours_between(NOW, later) == ref_clock.hours_between(NOW, later) == 30.0
    assert clock.days_between(later, NOW) == ref_clock.days_between(later, NOW) == 0.0
    for text in ("", "abc", "ünï"):
        assert hashing.content_hash(text) == ref_hashing.content_hash(text)
        assert hashing.cache_key("a", text) == ref_hashing.cache_key("a", text)


def test_geohash_equals_reference():
    rng = np.random.default_rng(2)
    for lat, lon in zip(rng.uniform(-90, 90, 50), rng.uniform(-180, 180, 50)):
        for p in (1, 5, 10):
            gh = geohash.encode(lat, lon, p)
            assert gh == ref_geohash.encode(lat, lon, p)
            assert geohash.decode(gh) == ref_geohash.decode(gh)
        assert geohash.cover(lat, lon, 800.0) == ref_geohash.cover(lat, lon, 800.0)
        assert geohash.haversine_m(lat, lon, 10.0, 20.0) == ref_geohash.haversine_m(lat, lon, 10.0, 20.0)


@pytest.mark.parametrize("flags", [{}, {"boost_importance": False}, {"boost_recency": False},
                                   {"boost_arousal": False, "boost_credibility": False},
                                   {"recency_scale": 0.0}])
def test_unified_score_equals_reference(flags, monkeypatch):
    rng = np.random.default_rng(4)
    n = 64
    cols = {"base": rng.random(n), "importance": rng.random(n), "hours_old": rng.random(n) * 900,
            "arousal": rng.random(n), "credibility": rng.random(n),
            "temporal_match": rng.choice([0.0, 0.1, 0.3, 0.5], n),
            "momentum": rng.uniform(-1, 1, n), "tag_penalty": rng.choice([1.0, 0.85, 0.9], n)}
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    for scale in (None, "0.25"):
        if scale:
            monkeypatch.setenv("SHODH_FEEDBACK_MOMENTUM_SCALE", scale)
        got = scoring.unified_score(scoring.ScoreInputs(**cols), **flags)
        want = ref_scoring.unified_score(ref_scoring.ScoreInputs(**cols), **flags)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    zeros = scoring.ScoreInputs.zeros(3)
    assert vars(zeros).keys() == vars(ref_scoring.ScoreInputs.zeros(3)).keys()
    for tags in ([], ["Auto-Captured"], ["assistant_response", "auto_captured"], ["x"]):
        assert scoring.tag_penalty_for(tags) == ref_scoring.tag_penalty_for(tags)


def test_feedback_store_equals_reference(tmp_path):
    """The same feedback sequence, with predictions and implicit follow-ups,
    gives the same momentum and the same stored bytes; each reads the other's."""
    stores = {}
    for name, kv_cls, fb_mod in (("port", KvStore, feedback), ("ref", RefKv, ref_feedback)):
        kv = kv_cls(tmp_path / name / "memories.db")
        fb = fb_mod.FeedbackStore(kv)
        fb.predict("a", 0.9)
        fb.record("a", -1.0, NOW)
        fb.record("a", 0.4, NOW + timedelta(days=1), alpha=0.5)
        fb.record("b", 3.0, NOW)  # clipped to 1
        fb.implicit_from_followup(["c", "d", "a"], "No, that's wrong", [], NOW)
        fb.implicit_from_followup(["e"], "thanks about Ana", ["Ana"], NOW)
        stores[name] = (kv, fb)
    (pkv, pfb), (rkv, rfb) = stores["port"], stores["ref"]
    for mid in "abcdez":
        assert pfb.momentum(mid) == rfb.momentum(mid)
    assert list(pkv.scan_prefix("fb")) == list(rkv.scan_prefix("fb"))
    cross = feedback.FeedbackStore(rkv)
    assert [cross.momentum(m) for m in "abcde"] == [rfb.momentum(m) for m in "abcde"]
    pfb.invalidate()
    assert pfb.momentum("a") == rfb.momentum("a")
