"""MIF v2 — vendor-neutral memory interchange export/import.

Reference: ``src/mif/schema.rs`` — the top-level document carries
``mif_version`` (a STRING, "2.0"), ``generator``, ``export_meta``,
``memories``, an optional nested ``knowledge_graph`` (entities /
relationships / episodes), ``todos``, ``projects``, ``reminders``, and a
``vendor_extensions`` map for lossless system-specific round-trips
(schema.rs:21-39). This module emits that exact shape and imports both
reference documents and this engine's own exports (including the round-1
flat layout, kept as a legacy reader).

Interchange rules honored from the reference:
- all enums lowercase snake_case (schema.rs:8)
- entity refs inside memories carry name/entity_type/confidence
  (schema.rs:113-121)
- graph node/edge IDs are UUIDs; this engine's canonical-name entity ids
  map to deterministic uuid5 values on export and resolve back by name on
  import
- vendor-specific learning state (importance, activation, tiers, Hebbian
  edge state, facts) rides in ``vendor_extensions["shodh-tpu"]``
  (schema.rs:35-38) so a shodh-tpu -> shodh-tpu round-trip is lossless
  while foreign importers can ignore it.
"""

from __future__ import annotations

import hashlib
import json
import uuid
from datetime import datetime
from pathlib import Path
from typing import Any, Optional

from shodh_tpu_torch import __version__
from shodh_tpu_torch.types import Experience, format_ts, parse_ts

MIF_VERSION = "2.0"
VENDOR = "shodh-tpu"
_NS = uuid.UUID("6d69662d-7632-5f73-686f-64682d747075")  # stable app namespace

# status maps: ours <-> reference MifTodo statuses (schema.rs:234)
_TODO_STATUS_OUT = {"pending": "todo", "in_progress": "in_progress",
                    "blocked": "blocked", "done": "done", "cancelled": "cancelled"}
_TODO_STATUS_IN = {"backlog": "pending", "todo": "pending", "in_progress": "in_progress",
                   "blocked": "blocked", "done": "done", "cancelled": "cancelled"}
_PRIORITY_IN = {"urgent": "urgent", "high": "high", "medium": "medium",
                "low": "low", "none": "low"}


def _uuidify(kind: str, key: str) -> str:
    """Deterministic UUID for a non-UUID internal id (canonical entity names)."""
    try:
        return str(uuid.UUID(key))
    except ValueError:
        return str(uuid.uuid5(_NS, f"{kind}:{key}"))


def export_mif(system, now: datetime, user_id: str = "default") -> dict[str, Any]:
    """Export a user's full memory state as a reference-compatible MIF v2 doc."""
    entity_labels: dict[str, str] = {}
    if system.graph is not None:
        entity_labels = {e.id: e.label for e in system.graph.entities.values()}

    memories = []
    vendor_mem: dict[str, Any] = {}
    for mem in system.storage.iter_memories():
        exp = mem.experience
        memories.append({
            "id": _uuidify("memory", mem.id),
            "content": exp.content,
            "memory_type": exp.experience_type.value,
            "created_at": format_ts(mem.created_at),
            "tags": list(exp.tags),
            "entities": [
                {"name": name,
                 "entity_type": entity_labels.get(name.lower(), "unknown"),
                 "confidence": 1.0}
                for name in exp.entities
            ],
            "metadata": {str(k): str(v) for k, v in exp.metadata.items()},
            "version": 1,
        })
        extras = exp.to_dict()
        for k in ("content", "tags", "metadata", "entities"):
            extras.pop(k, None)
        vendor_mem[mem.id] = {
            "importance": mem.importance, "activation": mem.activation,
            "access_count": mem.access_count, "tier": mem.tier.value,
            "content_hash": mem.content_hash, "experience_extras": extras,
        }

    doc: dict[str, Any] = {
        "mif_version": MIF_VERSION,
        "generator": {"name": VENDOR, "version": __version__},
        "export_meta": {
            "id": str(uuid.uuid5(_NS, f"export:{user_id}:{format_ts(now)}")),
            "created_at": format_ts(now),
            "user_id": user_id,
            "checksum": "",  # filled below over the canonical memories payload
        },
        "memories": memories,
        "todos": [],
        "projects": [],
        "reminders": [],
        "vendor_extensions": {},
    }

    if system.graph is not None:
        entities = []
        for e in system.graph.entities.values():
            node: dict[str, Any] = {
                "id": _uuidify("entity", e.id),
                "name": e.name,
                "types": [e.label],
                "attributes": {"canonical": e.id, "aliases": ",".join(e.aliases)}
                if e.aliases else {"canonical": e.id},
                "summary": "",
                "created_at": format_ts(e.first_seen or now),
                "last_seen_at": format_ts(e.last_seen or e.first_seen or now),
            }
            if e.fine_type:
                node["fine_type"] = e.fine_type
            entities.append(node)
        relationships = []
        for edge in system.graph.edges.values():
            relationships.append({
                "id": str(uuid.uuid5(_NS, f"edge:{edge.src}\x1f{edge.dst}\x1f{edge.rel_type}")),
                "source_entity_id": _uuidify("entity", edge.src),
                "target_entity_id": _uuidify("entity", edge.dst),
                "relation_type": edge.rel_type,
                "context": "",
                "confidence": max(0.0, min(1.0, edge.strength)),
                "created_at": format_ts(edge.created_at),
                "valid_at": format_ts(edge.created_at),
            })
        doc["knowledge_graph"] = {
            "entities": entities, "relationships": relationships, "episodes": [],
        }
        # Hebbian/LTP learning state is vendor-specific (schema.rs:7 principle 4)
        doc["vendor_extensions"].setdefault(VENDOR, {})["edges"] = [
            e.to_dict() for e in system.graph.edges.values()
        ]

    if system.todos is not None:
        for t in system.todos.list(include_done=True):
            doc["todos"].append({
                "id": _uuidify("todo", t.id),
                "content": t.title,
                "status": _TODO_STATUS_OUT.get(t.status, "todo"),
                "priority": t.priority,
                "created_at": format_ts(t.created_at),
                "updated_at": format_ts(t.completed_at or t.created_at),
                "due_date": format_ts(t.due) if t.due else None,
                "completed_at": format_ts(t.completed_at) if t.completed_at else None,
                "project_id": _uuidify("project", t.project_id) if t.project_id else None,
                "parent_id": _uuidify("todo", t.parent_id) if t.parent_id else None,
                "tags": list(t.tags),
                "contexts": [],
                "notes": t.description or None,
                "recurrence": t.recurrence,
                "comments": [
                    {"id": _uuidify("comment", c.id), "content": c.text,
                     "comment_type": "comment", "created_at": format_ts(c.created_at)}
                    for c in t.comments
                ],
            })
        for p in system.todos.list_projects():
            doc["projects"].append({
                "id": _uuidify("project", p.id), "name": p.name, "prefix": "",
                "description": p.description or None, "status": p.status,
                "created_at": format_ts(p.created_at),
            })

    if system.prospective is not None:
        for intent in system.prospective.pending():
            trigger: dict[str, Any]
            if intent.trigger_time is not None:
                trigger = {"type": "time", "at": format_ts(intent.trigger_time)}
            else:
                trigger = {"type": "context", "keywords": list(intent.context_keywords),
                           "threshold": 0.65}
            doc["reminders"].append({
                "id": _uuidify("reminder", intent.id),
                "content": intent.content,
                "trigger": trigger,
                "status": {"fired": "triggered"}.get(intent.status, intent.status),
                "priority": 3,
                "tags": [],
                "created_at": format_ts(intent.created_at),
                "triggered_at": format_ts(intent.fired_at) if intent.fired_at else None,
            })

    if system.facts is not None:
        doc["vendor_extensions"].setdefault(VENDOR, {})["facts"] = [
            f.to_dict() for f in system.facts.all_facts()
        ]
    doc["vendor_extensions"].setdefault(VENDOR, {})["memories"] = vendor_mem

    doc["export_meta"]["checksum"] = hashlib.sha256(
        json.dumps(memories, sort_keys=True).encode()
    ).hexdigest()
    return doc


def parse_mif_version(raw: Any) -> int:
    """Lenient major-version parse: accepts "2.0", "2", 2, "1.x"."""
    try:
        return int(str(raw).split(".", 1)[0])
    except (ValueError, TypeError):
        raise ValueError(f"unparseable MIF version {raw!r}")


def import_mif(system, doc: dict[str, Any]) -> dict[str, int]:
    """Import a MIF document (reference v2 shape or this engine's legacy
    round-1 flat shape). Memories re-embed + re-index (vectors are
    engine-internal, never interchanged); graph edges restore with their
    vendor-extension learning state when present."""
    version = parse_mif_version(doc.get("mif_version", 0))
    if version not in (1, 2):
        raise ValueError(f"unsupported MIF version {version}")
    if "knowledge_graph" in doc or "export_meta" in doc or "generator" in doc:
        return _import_v2(system, doc)
    return _import_legacy_flat(system, doc)


def _import_v2(system, doc: dict[str, Any]) -> dict[str, int]:
    counts = {"memories": 0, "facts": 0, "entities": 0, "relationships": 0,
              "todos": 0, "reminders": 0}
    vendor = (doc.get("vendor_extensions") or {}).get(VENDOR, {})
    # vendor extras are keyed by internal id; exported ids are uuidified —
    # precompute the exported-id -> extras map once
    vendor_mem = {
        _uuidify("memory", k): v for k, v in vendor.get("memories", {}).items()
    }

    for d in doc.get("memories", []):
        exp_dict: dict[str, Any] = {
            "content": d.get("content", ""),
            "experience_type": d.get("memory_type", "observation"),
            "tags": list(d.get("tags", [])),
            "metadata": dict(d.get("metadata", {})),
            "entities": [e["name"] for e in d.get("entities", []) if e.get("name")],
        }
        vm = vendor_mem.get(str(d.get("id")), {})
        exp_dict.update(vm.get("experience_extras", {}))
        exp = Experience.from_dict(exp_dict)
        created = parse_ts(d["created_at"]) if d.get("created_at") else None
        mem = system.remember(exp, created_at=created)
        if vm:
            mem.importance = float(vm.get("importance", mem.importance))
            mem.activation = float(vm.get("activation", mem.activation))
            system.storage.update(mem)
        counts["memories"] += 1

    kg = doc.get("knowledge_graph") or {}
    if system.graph is not None and kg:
        from shodh_tpu_torch.graph.graph_memory import EntityNode, canonical_name, _edge_key
        from shodh_tpu_torch.graph.plasticity import Edge, new_edge

        id_to_name: dict[str, str] = {}
        for d in kg.get("entities", []):
            canon = (d.get("attributes") or {}).get("canonical") or canonical_name(d["name"])
            id_to_name[str(d["id"])] = canon
            if canon in system.graph.entities:
                continue
            types = d.get("types") or ["concept"]
            aliases = (d.get("attributes") or {}).get("aliases", "")
            ent = EntityNode(
                id=canon, name=d["name"], label=types[0],
                fine_type=d.get("fine_type", ""),
                first_seen=parse_ts(d["created_at"]) if d.get("created_at") else None,
                last_seen=parse_ts(d["last_seen_at"]) if d.get("last_seen_at") else None,
                aliases=[a for a in aliases.split(",") if a],
            )
            system.graph.entities[ent.id] = ent
            system.graph._dirty_entities.add(ent.id)
            counts["entities"] += 1

        vendor_edges = {
            _edge_key(e["src"], e["dst"]): e for e in vendor.get("edges", [])
        }
        for d in kg.get("relationships", []):
            src = id_to_name.get(str(d.get("source_entity_id", "")))
            dst = id_to_name.get(str(d.get("target_entity_id", "")))
            if not src or not dst or src == dst:
                continue
            key = _edge_key(src, dst)
            if key in system.graph.edges:
                continue
            if key in vendor_edges:  # lossless Hebbian state round-trip
                edge = Edge.from_dict(vendor_edges[key])
            else:
                created = parse_ts(d["created_at"]) if d.get("created_at") else parse_ts(d["valid_at"])
                edge = new_edge(src, dst, d.get("relation_type", "related_to"), created,
                                initial_strength=d.get("confidence"))
            system.graph.edges[key] = edge
            system.graph.adjacency.setdefault(edge.src, set()).add(edge.dst)
            system.graph.adjacency.setdefault(edge.dst, set()).add(edge.src)
            system.graph._dirty_edges.add(key)
            counts["relationships"] += 1
        system.graph.flush()

    if system.todos is not None:
        from shodh_tpu_torch.engine.todos import Comment, Todo

        proj_names = {str(p["id"]): p for p in doc.get("projects", [])}
        proj_map: dict[str, str] = {}
        for pid, p in proj_names.items():
            existing = [q for q in system.todos.list_projects() if q.name == p["name"]]
            if existing:
                proj_map[pid] = existing[0].id
            else:
                created = parse_ts(
                    p.get("created_at")
                    or (doc.get("export_meta") or {}).get("created_at")
                    or "1970-01-01T00:00:00Z"
                )
                proj = system.todos.add_project(
                    p["name"], created, description=p.get("description") or "")
                proj_map[pid] = proj.id
        for d in doc.get("todos", []):
            todo = Todo(
                id=str(d["id"]), title=d.get("content", ""),
                description=d.get("notes") or "",
                status=_TODO_STATUS_IN.get(d.get("status", "todo"), "pending"),
                priority=_PRIORITY_IN.get(d.get("priority", "medium"), "medium"),
                created_at=parse_ts(d["created_at"]),
                due=parse_ts(d["due_date"]) if d.get("due_date") else None,
                recurrence=d.get("recurrence"),
                project_id=proj_map.get(str(d.get("project_id"))),
                tags=list(d.get("tags", [])),
                parent_id=str(d["parent_id"]) if d.get("parent_id") else None,
                comments=[
                    Comment(id=str(c["id"]), text=c.get("content", ""),
                            created_at=parse_ts(c["created_at"]))
                    for c in d.get("comments", [])
                ],
                completed_at=parse_ts(d["completed_at"]) if d.get("completed_at") else None,
            )
            system.todos.update(todo)  # upsert by id
            counts["todos"] += 1

    if system.prospective is not None:
        for d in doc.get("reminders", []):
            trig = d.get("trigger") or {}
            created = parse_ts(d["created_at"])
            if trig.get("type") == "time":
                system.prospective.add(d.get("content", ""), created,
                                       trigger_time=parse_ts(trig["at"]))
            elif trig.get("type") == "duration":
                start = parse_ts(trig["from"]) if trig.get("from") else created
                from datetime import timedelta
                system.prospective.add(d.get("content", ""), created,
                                       trigger_time=start + timedelta(seconds=int(trig.get("seconds", 0))))
            else:
                system.prospective.add(d.get("content", ""), created,
                                       context_keywords=list(trig.get("keywords", [])))
            counts["reminders"] += 1

    if system.facts is not None and vendor.get("facts"):
        from shodh_tpu_torch.engine.facts import SemanticFact

        for d in vendor["facts"]:
            system.facts.store(SemanticFact.from_dict(d))
            counts["facts"] += 1
    return counts


def _import_legacy_flat(system, doc: dict[str, Any]) -> dict[str, int]:
    """Round-1 shodh-tpu layout: flat entities/relationships, memories carry
    the full experience dict."""
    counts = {"memories": 0, "facts": 0, "entities": 0, "relationships": 0,
              "todos": 0, "reminders": 0}
    for d in doc.get("memories", []):
        exp = Experience.from_dict(d.get("experience", d))
        created = parse_ts(d["created_at"]) if d.get("created_at") else None
        mem = system.remember(exp, created_at=created)
        if "importance" in d:
            mem.importance = float(d["importance"])
            system.storage.update(mem)
        counts["memories"] += 1
    if system.facts is not None:
        from shodh_tpu_torch.engine.facts import SemanticFact

        for d in doc.get("facts", []):
            system.facts.store(SemanticFact.from_dict(d))
            counts["facts"] += 1
    if system.graph is not None:
        from shodh_tpu_torch.graph.graph_memory import EntityNode, _edge_key
        from shodh_tpu_torch.graph.plasticity import Edge

        for d in doc.get("entities", []):
            ent = EntityNode.from_dict(d)
            if ent.id not in system.graph.entities:
                system.graph.entities[ent.id] = ent
                system.graph._dirty_entities.add(ent.id)
                counts["entities"] += 1
        for d in doc.get("relationships", []):
            edge = Edge.from_dict(d)
            key = _edge_key(edge.src, edge.dst)
            if key not in system.graph.edges:
                system.graph.edges[key] = edge
                system.graph.adjacency.setdefault(edge.src, set()).add(edge.dst)
                system.graph.adjacency.setdefault(edge.dst, set()).add(edge.src)
                system.graph._dirty_edges.add(key)
                counts["relationships"] += 1
        system.graph.flush()
    if system.todos is not None:
        from shodh_tpu_torch.engine.todos import Todo

        for d in doc.get("todos", []):
            system.todos.update(Todo.from_dict(d))  # upsert by id
            counts["todos"] += 1
    return counts


def export_to_file(system, path: str | Path, now: datetime) -> None:
    Path(path).write_text(json.dumps(export_mif(system, now), indent=1))


def import_from_file(system, path: str | Path) -> dict[str, int]:
    return import_mif(system, json.loads(Path(path).read_text()))
