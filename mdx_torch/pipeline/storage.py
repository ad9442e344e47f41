"""SQLite persistence DAO (ref pipeline/storage.py).

The port's copy of ``mdx/pipeline/storage.py``: the same schema SQL and
calls, so one DB file (``MDX_DB_PATH``, else ``MDIMG_DB_PATH``) is read and
written by both packages, and a batch begun by one resumes in the other (a
CPU test holds both).  Same observable behaviour as the reference:
WAL-mode SQLite, ``runs`` + ``chat_messages`` tables with JSON-in-TEXT
columns, connection-per-call, status lifecycle pending → running →
completed/error.  The run id is always passed explicitly.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
import uuid
from typing import Any, Dict, List, Optional

from mdx_torch import telemetry

_DEFAULT_DB = "mdx_runs.db"


def db_path() -> str:
    # MDIMG_DB_PATH honoured for drop-in compatibility with reference
    # deployments (ref backend/config.py:26, README env inventory).
    return (os.environ.get("MDX_DB_PATH")
            or os.environ.get("MDIMG_DB_PATH")
            or _DEFAULT_DB)


def _connect() -> sqlite3.Connection:
    conn = sqlite3.connect(db_path(), timeout=30.0)
    conn.execute("PRAGMA journal_mode=WAL")
    conn.row_factory = sqlite3.Row
    return conn


_SCHEMA_SQL = """
CREATE TABLE IF NOT EXISTS runs (
    run_id TEXT PRIMARY KEY,
    created_at REAL NOT NULL,
    input_filename TEXT NOT NULL DEFAULT '',
    status TEXT NOT NULL DEFAULT 'pending',
    error TEXT NOT NULL DEFAULT '',
    metadata_summary TEXT NOT NULL DEFAULT '{}',
    issues TEXT NOT NULL DEFAULT '[]',
    metrics_before TEXT NOT NULL DEFAULT '{}',
    metrics_after TEXT NOT NULL DEFAULT '{}',
    plan_json TEXT NOT NULL DEFAULT '',
    validation TEXT NOT NULL DEFAULT '{}',
    applied_ops TEXT NOT NULL DEFAULT '[]',
    explainability TEXT NOT NULL DEFAULT '{}',
    report_path TEXT NOT NULL DEFAULT '',
    before_after_path TEXT NOT NULL DEFAULT '',
    agent_logs TEXT NOT NULL DEFAULT '[]',
    genai_model TEXT NOT NULL DEFAULT '',
    genai_llm_calls INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS chat_messages (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id TEXT NOT NULL,
    role TEXT NOT NULL,
    content TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_chat_run ON chat_messages(run_id, id);
"""


def init_db() -> None:
    # sqlite cannot create parent directories (fresh deploys default to
    # <root>/data/mdx.db, which does not exist yet)
    parent = os.path.dirname(os.path.abspath(db_path()))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with _connect() as conn:
        conn.executescript(_SCHEMA_SQL)


def mark_orphaned_runs() -> int:
    """Flip stale pending/running rows to error at server startup.

    A crashed process leaves its in-flight runs permanently "running" (the
    reference shares this flaw, SURVEY.md §5 checkpoint/resume); the API
    and legacy servers call this once at startup so pollers see a terminal
    state.  Returns the number of rows repaired."""
    with _connect() as conn:
        cur = conn.execute(
            "UPDATE runs SET status = 'error',"
            " error = 'orphaned by server restart'"
            " WHERE status IN ('pending', 'running')")
        return cur.rowcount


def generate_run_id() -> str:
    """12-hex run id (ref pipeline/storage.py:89)."""
    return uuid.uuid4().hex[:12]


def _serialise(value: Any) -> str:
    """JSON-encode tolerating numpy scalars and dataclass-like objects."""
    def _default(o):
        for attr in ("item", "tolist"):
            if hasattr(o, attr):
                try:
                    return getattr(o, attr)()
                except Exception:
                    pass
        if hasattr(o, "__dict__"):
            return {k: v for k, v in o.__dict__.items() if not k.startswith("_")}
        return str(o)
    return json.dumps(value, default=_default)


def insert_pending_run(run_id: str, input_filename: str) -> None:
    with _connect() as conn:
        conn.execute(
            "INSERT OR REPLACE INTO runs (run_id, created_at, input_filename, status)"
            " VALUES (?, ?, ?, 'pending')",
            (run_id, time.time(), input_filename))


def update_run_status(run_id: str, status: str, error: str = "") -> None:
    with _connect() as conn:
        conn.execute("UPDATE runs SET status = ?, error = ? WHERE run_id = ?",
                     (status, error, run_id))


def save_run(
    *,
    run_id: str,
    input_filename: str,
    metadata_summary: Dict,
    issues: List,
    metrics_before: Dict,
    metrics_after: Dict,
    plan_json: str,
    validation: Dict,
    applied_ops: List,
    explainability: Dict,
    report_path: str,
    before_after_path: str,
    agent_logs: List,
    status: str = "completed",
    genai_model: str = "",
    genai_llm_calls: int = 0,
) -> None:
    with telemetry.span("db", frames=1), _connect() as conn:
        conn.execute(
            """INSERT OR REPLACE INTO runs
               (run_id, created_at, input_filename, status, metadata_summary,
                issues, metrics_before, metrics_after, plan_json, validation,
                applied_ops, explainability, report_path, before_after_path,
                agent_logs, genai_model, genai_llm_calls)
               VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
            (run_id, time.time(), input_filename, status,
             _serialise(metadata_summary), _serialise(issues),
             _serialise(metrics_before), _serialise(metrics_after),
             plan_json, _serialise(validation), _serialise(applied_ops),
             _serialise(explainability), report_path, before_after_path,
             _serialise(agent_logs), genai_model, int(genai_llm_calls)))


def save_runs_bulk(rows: List[Dict[str, Any]]) -> None:
    """Insert many completed runs in ONE transaction (one fsync instead of
    one per frame — the batch runner persists a 64-frame chunk at a time).
    Each dict takes the same keyword fields as :func:`save_run`."""
    with telemetry.span("db", frames=len(rows)):
        now = time.time()
        payload = [
            (r["run_id"], now, r["input_filename"], r.get("status", "completed"),
             _serialise(r["metadata_summary"]), _serialise(r["issues"]),
             _serialise(r["metrics_before"]), _serialise(r["metrics_after"]),
             r["plan_json"], _serialise(r["validation"]),
             _serialise(r["applied_ops"]), _serialise(r["explainability"]),
             r["report_path"], r["before_after_path"],
             _serialise(r["agent_logs"]), r.get("genai_model", ""),
             int(r.get("genai_llm_calls", 0)))
            for r in rows]
        with _connect() as conn:
            conn.executemany(
                """INSERT OR REPLACE INTO runs
                   (run_id, created_at, input_filename, status, metadata_summary,
                    issues, metrics_before, metrics_after, plan_json, validation,
                    applied_ops, explainability, report_path, before_after_path,
                    agent_logs, genai_model, genai_llm_calls)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                payload)


_JSON_COLS = ("metadata_summary", "issues", "metrics_before", "metrics_after",
              "validation", "applied_ops", "explainability", "agent_logs")


def _row_to_dict(row: sqlite3.Row) -> Dict[str, Any]:
    d = dict(row)
    for col in _JSON_COLS:
        if col in d and isinstance(d[col], str):
            try:
                d[col] = json.loads(d[col]) if d[col] else None
            except json.JSONDecodeError:
                pass
    return d


def get_run(run_id: str) -> Optional[Dict[str, Any]]:
    with _connect() as conn:
        row = conn.execute("SELECT * FROM runs WHERE run_id = ?", (run_id,)).fetchone()
    return _row_to_dict(row) if row else None


def get_run_status(run_id: str) -> Optional[Dict[str, str]]:
    with _connect() as conn:
        row = conn.execute("SELECT run_id, status, error FROM runs WHERE run_id = ?",
                           (run_id,)).fetchone()
    return dict(row) if row else None


def list_runs(limit: int = 50, offset: int = 0) -> List[Dict[str, Any]]:
    with _connect() as conn:
        rows = conn.execute(
            "SELECT run_id, created_at, input_filename, status, issues,"
            " genai_model FROM runs ORDER BY created_at DESC LIMIT ? OFFSET ?",
            (limit, offset)).fetchall()
    out = []
    for row in rows:
        d = dict(row)
        try:
            d["issues"] = json.loads(d["issues"]) if d["issues"] else []
        except json.JSONDecodeError:
            d["issues"] = []
        out.append(d)
    return out


def save_chat_message(run_id: str, role: str, content: str) -> None:
    with _connect() as conn:
        conn.execute(
            "INSERT INTO chat_messages (run_id, role, content, created_at)"
            " VALUES (?, ?, ?, ?)", (run_id, role, content, time.time()))


def get_chat_history(run_id: str, limit: int = 50) -> List[Dict[str, Any]]:
    """The NEWEST ``limit`` messages in chronological order (taking the
    oldest rows would freeze the LLM context once a chat exceeds the
    limit)."""
    with _connect() as conn:
        rows = conn.execute(
            "SELECT role, content, created_at FROM chat_messages"
            " WHERE run_id = ? ORDER BY id DESC LIMIT ?",
            (run_id, limit)).fetchall()
    return [dict(r) for r in reversed(rows)]
