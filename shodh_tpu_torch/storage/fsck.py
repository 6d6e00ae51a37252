"""Offline store integrity check + repair.

One entry point for what the reference spreads across consolidation's
verify/rebuild and storage's cleanup (consolidation.rs repair = verify +
conditional rebuild; storage.rs:2975 cleanup_corrupted): decode every
record, then cross-check each derived structure against the memory set —
content-hash dedup map, secondary index keys, vector row maps, BM25
posting docs, temporal-fact sources, and the lexical fingerprint stamp
(retrieval.bm25.lexical_fingerprint).

``check_store`` is read-only and returns a structured report;
``repair_store`` fixes what the report found, preferring re-derivation
from stored content (the same replay machinery as the fold-drift
migration) over surgical patching, then re-checks.
"""

from __future__ import annotations

from typing import Any

from shodh_tpu_torch.engine.temporal_facts import NS_TFACT, NS_TFACT_ENT
from shodh_tpu_torch.storage.store import (
    NS_HASH,
    NS_IDX,
    NS_MEM,
)


def public_report(report: dict[str, Any]) -> dict[str, Any]:
    """Report without the underscore-prefixed repair worklists."""
    return {k: v for k, v in report.items() if not k.startswith("_")}


def check_store(system) -> dict[str, Any]:
    """Read-only integrity report for an open MemorySystem."""
    from shodh_tpu_torch.retrieval.bm25 import lexical_fingerprint
    from shodh_tpu_torch.storage.serialization import CorruptRecordError, decode

    # Integrity is a statement about the ON-DISK state: the read-through
    # caches (memory LRU, vecmap/rowmap) must not mask kv-level damage.
    system.storage.clear_caches()
    kv = system.storage.kv
    report: dict[str, Any] = {}

    # 1. Record decode + the live id set everything else is checked against
    ids: set[str] = set()
    corrupt = 0
    mems = {}
    for k, v in kv.scan_prefix(NS_MEM, ""):
        try:
            from shodh_tpu_torch.types import Memory

            mems[k] = Memory.from_dict(decode(v))
            ids.add(k)
        except CorruptRecordError:
            corrupt += 1
    report["memories"] = len(ids)
    report["corrupt_records"] = corrupt

    # 2. Content-hash dedup map: bijective with live records
    hash_dangling = []
    hashed_ids = set()
    for chash, raw in kv.scan_prefix(NS_HASH, ""):
        mid = raw.decode()
        if mid not in ids:
            hash_dangling.append(chash)
        else:
            hashed_ids.add(mid)
    hash_missing = [
        mid for mid, m in mems.items() if m.content_hash and mid not in hashed_ids
    ]
    report["hash_index"] = {"dangling": len(hash_dangling), "missing": len(hash_missing)}

    # 3. Secondary index keys: every live memory's keys present, none dangling
    expected_keys: set[str] = set()
    for m in mems.values():
        expected_keys |= system.storage._index_keys(m)
    actual_keys = {k for k, _ in kv.scan_prefix(NS_IDX, "")}
    report["secondary_index"] = {
        "missing": len(expected_keys - actual_keys),
        "dangling": len(actual_keys - expected_keys),
    }

    # 4. Vector row maps: row -> memory inverse agrees (index repair route
    # check, app.py index_repair) and every live memory has text rows
    row_mismatch = 0
    missing_maps = 0
    stale_rows = 0  # mapped text rows absent/deleted in the loaded index
    stale_modality = 0  # same, for image/audio/video indexes
    mapped: dict[str, set[int]] = {}
    system.index.flush()

    def _index_of(modality):
        return system.index if modality == "text" else system.modality_indexes.get(modality)

    for mid in ids:
        vm = system.storage.get_vector_map(mid)
        if "text" not in vm or not vm["text"]:
            missing_maps += 1
        for modality, rows in vm.items():
            if not (modality == "text" and not rows):  # counted above
                idx_obj = _index_of(modality)
                for r in rows:
                    if system.storage.memory_for_row(r, modality) != mid:
                        row_mismatch += 1
                    mapped.setdefault(modality, set()).add(r)
                    if idx_obj is None or not idx_obj.row_active(r):
                        if modality == "text":
                            stale_rows += 1
                        else:
                            stale_modality += 1
    report["vector_map"] = {"row_mismatches": row_mismatch, "missing": missing_maps}

    # 4.5 Device indexes vs kv: epoch agreement (compaction crash window),
    # no mapped row missing from its index, no active row unmapped
    kv_epoch = int((kv.get("meta", "index_epoch") or b"0").decode())
    orphan_rows = 0
    for modality in ("text", *system.modality_indexes.keys()):
        idx_obj = _index_of(modality)
        if idx_obj is None:
            continue
        seen = mapped.get(modality, set())
        orphan_rows += sum(
            1 for r in range(len(idx_obj)) if idx_obj.row_active(r) and r not in seen
        )
    report["index"] = {
        "epoch_ok": kv_epoch == system.index.epoch,
        "stale_mapped_rows": stale_rows,
        "stale_modality_rows": stale_modality,
        "orphan_active_rows": orphan_rows,
    }

    # 5. BM25 posting docs: live memories indexed, no orphan docs
    if system.bm25 is not None and system.bm25.kv is not None:
        bm25_ids = {doc_id for doc_id, _ in system.bm25.kv.scan_prefix("bm25doc", "")}
        report["bm25"] = {
            "missing": len(ids - bm25_ids),
            "orphans": len(bm25_ids - ids),
        }
    else:
        report["bm25"] = {"missing": 0, "orphans": 0}

    # 6. Temporal facts: sources must exist
    tfact_dangling = []
    for fid, raw in kv.scan_prefix(NS_TFACT, ""):
        try:
            fact = decode(raw)
        except CorruptRecordError:
            tfact_dangling.append(fid)
            continue
        if fact.get("source_memory") not in ids:
            tfact_dangling.append(fid)
    report["temporal_facts"] = {"dangling": len(tfact_dangling)}
    report["_tfact_dangling_ids"] = tfact_dangling

    # 6.5 Graph ingest coverage: an enriched memory with graph-eligible
    # entities must appear in some entity's memory list (NS_ENTMEM) — the
    # graph buffers mutations and flushes at maintenance/save, so a crash
    # can lose ingests the kv store kept
    graph_missing: list[str] = []
    if system.graph is not None:
        from shodh_tpu_torch.graph.graph_memory import graph_eligible_name

        ingested: set[str] = set()
        for mem_list in system.graph.entity_memories.values():
            ingested.update(mem_list)
        for mid, m in mems.items():
            exp = m.experience
            if (
                mid not in ingested
                and exp.entities
                and "_enrich_pending" not in exp.metadata
                and any(graph_eligible_name(e) for e in exp.entities)
            ):
                graph_missing.append(mid)
    report["graph"] = {"missing_ingests": len(graph_missing)}
    report["_graph_missing_ids"] = graph_missing

    # 7. Lexical stamp: stored postings/vectors stemmed under current rules
    stamp = kv.get("meta", "lexical_fp")
    report["lexical_stamp"] = {
        "present": stamp is not None,
        "current": stamp is not None and stamp.decode() == lexical_fingerprint(),
    }

    report["ok"] = (
        corrupt == 0
        and not hash_dangling
        and not hash_missing
        and report["secondary_index"]["missing"] == 0
        and report["secondary_index"]["dangling"] == 0
        and row_mismatch == 0
        and missing_maps == 0
        and report["index"]["epoch_ok"]
        and stale_rows == 0
        and stale_modality == 0
        and orphan_rows == 0
        and report["bm25"]["missing"] == 0
        and report["bm25"]["orphans"] == 0
        and not tfact_dangling
        and not graph_missing
        and report["lexical_stamp"]["current"]
    )
    return report


def repair_store(system, report: dict[str, Any] | None = None) -> dict[str, Any]:
    """Fix what ``check_store`` found; returns the post-repair report.

    Strategy: drop undecodable records first, then re-derive every
    derived structure from the surviving content — hash map and secondary
    index keys by re-putting each record through the storage update path,
    postings/vectors via the fold-drift replay (migrate_lexical, which
    also restamps), and orphan cleanup by deletion.
    """
    report = report or check_store(system)
    if report["ok"]:
        return report

    system.storage.clear_caches()  # repairs rewrite kv under the caches
    kv = system.storage.kv
    system.storage.cleanup_corrupted()
    live = set(system.storage.iter_ids())

    # hash map: drop dangling, re-put missing
    ops = []
    for chash, raw in kv.scan_prefix(NS_HASH, ""):
        if raw.decode() not in live:
            ops.append(("del", NS_HASH, chash, None))
    for mem in system.storage.iter_memories():
        if mem.content_hash:
            ops.append(("put", NS_HASH, mem.content_hash, mem.id.encode()))
    if ops:
        kv.write_batch(ops)

    # secondary index: drop dangling keys, then re-put every record's keys
    expected: set[str] = set()
    for mem in system.storage.iter_memories():
        expected |= system.storage._index_keys(mem)
    ops = [
        ("del", NS_IDX, k, None)
        for k, _ in kv.scan_prefix(NS_IDX, "")
        if k not in expected
    ]
    ops.extend(("put", NS_IDX, k, b"") for k in expected)
    kv.write_batch(ops)

    # orphan bm25 docs
    if system.bm25 is not None and system.bm25.kv is not None:
        for doc_id, _ in list(system.bm25.kv.scan_prefix("bm25doc", "")):
            if doc_id not in live:
                system.bm25.delete(doc_id)

    # dangling temporal facts (+ their entity keys)
    for fid in report.get("_tfact_dangling_ids", []):
        ops = [("del", NS_TFACT, fid, None)]
        ops.extend(
            ("del", NS_TFACT_ENT, key, None)
            for key, _ in kv.scan_prefix(NS_TFACT_ENT, "")
            if key.endswith(f":{fid}")
        )
        kv.write_batch(ops)

    # postings + vectors + row maps + index + stamp: full content replay.
    # Index problems (epoch mismatch, stale/orphan rows) rebuild into a
    # FRESH index — a layout mismatch means existing row ids may point at
    # the wrong vectors, so nothing targeted is trustworthy — and the same
    # replay re-derives postings and restamps, one pass for everything.
    vec = report["vector_map"]
    idx = report["index"]
    if (
        not report["lexical_stamp"]["current"]
        or report["bm25"]["missing"]
        or vec["row_mismatches"]
        or vec["missing"]
        or not idx["epoch_ok"]
        or idx["stale_mapped_rows"]
        or idx["orphan_active_rows"]
    ):
        from shodh_tpu_torch.index.device_index import DeviceVectorIndex

        fresh = DeviceVectorIndex(dim=system.embedder.dimension, dtype=system.index.dtype,
                                  device=system.device)
        fresh.epoch = system.index.epoch
        system.index = fresh
        if system._device_funnel is not None:
            system._device_funnel.invalidate()
        # fresh_index: stale row ids must never be trusted against the new
        # index (they can alias just-assigned rows) — every memory re-adds
        system.migrate_lexical(fresh_index=True)
        kv.put("meta", "index_epoch", str(system.index.epoch).encode())
        system.storage.set_text_rows_hwm(len(system.index))
        system.index.save(system.data_dir / "index" / "text")

    # modality indexes rebuild wholesale from the persisted per-experience
    # embeddings; modalities with no surviving sources are DROPPED (index
    # object + snapshot files), else an orphan-only index reloads forever
    if idx["stale_modality_rows"] or idx["orphan_active_rows"]:
        import numpy as np

        from shodh_tpu_torch.index.device_index import DeviceVectorIndex

        rebuilt: dict[str, DeviceVectorIndex] = {}
        for mem in sorted(system.storage.iter_memories(), key=lambda m: (m.created_at, m.id)):
            exp = mem.experience
            for modality, emb in (
                ("image", exp.image_embeddings),
                ("audio", exp.audio_embeddings),
                ("video", exp.video_embeddings),
            ):
                if emb is None:
                    continue
                vec = np.asarray(emb, np.float32)
                vec = vec / max(float(np.linalg.norm(vec)), 1e-12)
                midx = rebuilt.get(modality)
                if midx is None:
                    midx = rebuilt[modality] = DeviceVectorIndex(dim=vec.shape[0],
                                                                 device=system.device)
                rows = midx.add(vec[None, :])
                system.storage.set_vector_rows(mem.id, rows, modality=modality)
        for dropped in set(system.modality_indexes) - set(rebuilt):
            for suffix in (".json", ".npz"):
                path = (system.data_dir / "index" / dropped).with_suffix(suffix)
                if path.exists():
                    path.unlink()
        system.modality_indexes = rebuilt
        for modality, midx in rebuilt.items():
            midx.save(system.data_dir / "index" / modality)

    # graph ingests lost to the flush window: re-ingest structure from the
    # record (NER labels re-derive deterministically from content). Learned
    # plasticity state for the lost edges restarts from baseline — the
    # record never stored it, so structure is what repair can promise.
    if report.get("_graph_missing_ids") and system.graph is not None:
        from shodh_tpu_torch import constants as C

        for mid in report["_graph_missing_ids"]:
            mem = system.storage.get(mid)
            if mem is None:
                continue
            labels: dict[str, str] = {}
            fine: dict[str, str] = {}
            if system.ner is not None:
                try:
                    mentions = system.ner.extract(mem.experience.content)
                    labels = {
                        m.text: m.label
                        for m in mentions
                        if m.confidence >= C.NER_GRAPH_CONFIDENCE_FLOOR
                    }
                    fine = {
                        m.text: m.fine
                        for m in mentions
                        if m.fine and m.confidence >= C.NER_GRAPH_CONFIDENCE_FLOOR
                    }
                except Exception:  # rules fallback inside NER already guards; be safe
                    pass
            system.graph.ingest_experience(
                mem, now=mem.created_at, entity_labels=labels, entity_fine=fine
            )
        system.graph.flush()

    return check_store(system)
