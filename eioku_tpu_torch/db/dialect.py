"""SQL dialects: the dual PostgreSQL/SQLite surface the reference ships.

Copy of eioku_tpu/db/dialect.py for the PyTorch port.

The reference deploys PostgreSQL 16 (dev/docker-compose.yml:68)
and branches dialect-divergent SQL in its services — PG tsvector/ts_headline vs
SQLite FTS5/snippet() in find (find_within_video_service.py:139-264), PG upsert
vs SQLite REPLACE in projections (projection_sync_service.py:72-119), PG
`DISTINCT ON` for latest-per-language selection (artifact_repository.py:258-287),
JSONB operators for payload filters (artifact_repository.py:173-182). This
module is that branch point: every dialect-divergent statement in the
repositories/services is built by a Dialect method, so both SQL surfaces are
real, unit-testable code (tests/test_pg_dialect.py) rather than comments.

Everything else in the schema is deliberately ANSI-portable: TEXT/INTEGER/REAL
columns (payload_json stays TEXT and is cast `::jsonb` inside PG expressions),
`ON CONFLICT ... DO UPDATE ... excluded.*` upserts, and `UPDATE/INSERT ...
RETURNING` all parse identically on PostgreSQL and SQLite >= 3.35.

Execution against a live PostgreSQL server uses psycopg2/pg8000 when
importable, else the first-party wire-protocol client (db/pgwire.py) — see
connection.PostgresDatabase. The SQL itself is exercised by golden tests
either way.
"""
from __future__ import annotations

_SNIP_OPEN, _SNIP_CLOSE, _SNIP_WORDS = "<b>", "</b>", 12


class Dialect:
    """Shared (portable) builders + the divergent-surface interface."""

    name: str
    paramstyle: str  # DBAPI paramstyle of the wire format ("qmark"/"format")

    # -- portable builders -----------------------------------------------------

    def upsert(self, table: str, cols: list[str], conflict_cols: list[str]) -> str:
        """Full-row upsert. Replaces SQLite-only `INSERT OR REPLACE` (which
        delete+inserts, firing ON DELETE cascades) with the `ON CONFLICT ...
        DO UPDATE` form both engines execute identically."""
        placeholders = ",".join("?" * len(cols))
        updates = ", ".join(f"{c}=excluded.{c}" for c in cols
                            if c not in conflict_cols)
        return (f"INSERT INTO {table} ({', '.join(cols)})"
                f" VALUES ({placeholders})"
                f" ON CONFLICT({', '.join(conflict_cols)}) DO UPDATE SET {updates}")

    # -- JSON payload access -----------------------------------------------------

    def json_field(self, col: str) -> str:
        """Expression extracting a payload field; binds ONE param: the bare
        key name (e.g. 'label')."""
        raise NotImplementedError

    def json_field_literal(self, col: str, key: str) -> str:
        """Same, with the key inlined as a literal (no param)."""
        raise NotImplementedError

    def json_path(self, col: str) -> str:
        """Expression extracting by a bound JSONPath param like '$.label' or
        '$.predictions[0].label' (the jump-options aggregation paths)."""
        raise NotImplementedError

    def json_array_contains(self, col: str) -> str:
        """Predicate: payload array field (bound key param) contains the bound
        value param. Two params: key, value. Reference uses the JSONB `?`
        operator (artifact_repository.py:173-182)."""
        raise NotImplementedError

    # -- full-text search ----------------------------------------------------

    def fts_schema(self, fts_table: str, meta_table: str,
                   meta_index: str) -> str:
        """DDL script for one FTS projection (content + sidecar meta table
        joined on rowid; both dialects keep the same two-table topology so
        the query layer is structurally identical)."""
        raise NotImplementedError

    def fts_from(self, fts_table: str, meta_table: str) -> str:
        """FROM clause joining content to meta. The PG form also binds the
        query param here (to_tsquery aliased as q, the standard single-bind
        trick so ts_headline/ts_rank reuse it); SQLite binds it in the MATCH
        predicate instead — either way exactly ONE query param, first."""
        raise NotImplementedError

    def fts_match_where(self, fts_table: str) -> str:
        raise NotImplementedError

    def fts_snippet(self, fts_table: str) -> str:
        raise NotImplementedError

    def fts_rank(self, fts_table: str) -> str:
        raise NotImplementedError

    def fts_order_by_rank(self, fts_table: str) -> str:
        """ORDER BY expression, best match first."""
        raise NotImplementedError

    def fts_score(self, raw_rank: float) -> float:
        """Normalize the engine's rank to higher-is-better."""
        raise NotImplementedError

    def fts_match_expr(self, terms: list[str]) -> str:
        """AND-of-terms query expression from sanitized word terms."""
        raise NotImplementedError

    def ilike(self) -> str:
        """Case-insensitive LIKE operator (the reference's ILIKE fallback)."""
        raise NotImplementedError

    def fts_vocab_setup(self, fts_table: str) -> list[str]:
        """Idempotent DDL needed before fts_vocab_terms (may be empty)."""
        raise NotImplementedError

    def fts_vocab_terms(self, fts_table: str) -> str:
        """SELECT (term, doc_count) over the index's vocabulary — the source
        for did-you-mean suggestions when a search yields nothing (spec req
        2.4, .kiro/specs/semantic-video-search/requirements.md)."""
        raise NotImplementedError

    # -- misc divergent expressions ----------------------------------------------

    def latest_run_per_language_clause(self) -> str:
        """WHERE fragment selecting artifacts of the newest run per distinct
        payload language; binds (asset_id, artifact_type)."""
        raise NotImplementedError

    def running_seconds_expr(self) -> str:
        """Sort expression for task running time (completed_at-or-now minus
        started_at); only ordering matters, not units."""
        raise NotImplementedError


class SqliteDialect(Dialect):
    name = "sqlite"
    paramstyle = "qmark"

    def json_field(self, col: str) -> str:
        return f"json_extract({col}, '$.' || ?)"

    def json_field_literal(self, col: str, key: str) -> str:
        return f"json_extract({col}, '$.{key}')"

    def json_path(self, col: str) -> str:
        return f"json_extract({col}, ?)"

    def json_array_contains(self, col: str) -> str:
        return (f"EXISTS (SELECT 1 FROM json_each({col}, '$.' || ?)"
                "            WHERE json_each.value = ?)")

    def fts_schema(self, fts_table: str, meta_table: str,
                   meta_index: str) -> str:
        return f"""
        CREATE VIRTUAL TABLE {fts_table} USING fts5(
            text, tokenize='porter unicode61'
        );
        CREATE TABLE {meta_table} (
            rowid INTEGER PRIMARY KEY,
            artifact_id TEXT NOT NULL UNIQUE,
            asset_id TEXT NOT NULL,
            start_ms INTEGER NOT NULL,
            end_ms INTEGER NOT NULL,
            language TEXT,
            run_id TEXT NOT NULL
        );
        CREATE INDEX {meta_index} ON {meta_table}(asset_id, start_ms);
        """

    def fts_from(self, fts_table: str, meta_table: str) -> str:
        return f"FROM {fts_table} f JOIN {meta_table} m ON m.rowid = f.rowid"

    def fts_match_where(self, fts_table: str) -> str:
        return f"f.{fts_table} MATCH ?"

    def fts_snippet(self, fts_table: str) -> str:
        return (f"snippet({fts_table}, 0, '{_SNIP_OPEN}', '{_SNIP_CLOSE}',"
                f" '…', {_SNIP_WORDS})")

    def fts_rank(self, fts_table: str) -> str:
        return "f.rank"

    def fts_order_by_rank(self, fts_table: str) -> str:
        return "f.rank"  # bm25: lower = better, ASC

    def fts_score(self, raw_rank: float) -> float:
        return -float(raw_rank)

    def fts_match_expr(self, terms: list[str]) -> str:
        return " AND ".join(f'"{t}"' for t in terms)

    def ilike(self) -> str:
        return "LIKE"  # SQLite LIKE is case-insensitive for ASCII by default

    def fts_vocab_setup(self, fts_table: str) -> list[str]:
        return [f"CREATE VIRTUAL TABLE IF NOT EXISTS {fts_table}_vocab"
                f" USING fts5vocab('{fts_table}', 'row')"]

    def fts_vocab_terms(self, fts_table: str) -> str:
        return f"SELECT term, doc FROM {fts_table}_vocab"

    def latest_run_per_language_clause(self) -> str:
        # SQLite guarantees bare columns come from the MAX row when a single
        # MAX() aggregate is present, so run_id is the newest run per lang.
        return (
            "run_id IN (SELECT run_id FROM ("
            " SELECT run_id, COALESCE(json_extract(payload_json,'$.language'),'') AS lang,"
            "        MAX(created_at || run_id) AS newest"
            " FROM artifacts WHERE asset_id=? AND artifact_type=?"
            " GROUP BY lang))"
        )

    def running_seconds_expr(self) -> str:
        return ("julianday(COALESCE(completed_at,"
                " strftime('%Y-%m-%dT%H:%M:%fZ','now'))) - julianday(started_at)")


class PostgresDialect(Dialect):
    """PostgreSQL 16 surface, mirroring the reference's PG branches.

    payload_json stays a TEXT column (shared DDL) and is cast to jsonb inside
    expressions; FTS uses an english tsvector GENERATED column + GIN index in
    place of FTS5, with the identical two-table rowid-join topology.
    """

    name = "postgresql"
    paramstyle = "format"

    def json_field(self, col: str) -> str:
        return f"({col}::jsonb ->> ?)"

    def json_field_literal(self, col: str, key: str) -> str:
        return f"({col}::jsonb ->> '{key}')"

    def json_path(self, col: str) -> str:
        # '$.predictions[0].label'-style paths are valid PG jsonpath; #>> '{}'
        # unwraps the jsonb scalar to text like ->> does for plain keys
        return f"(jsonb_path_query_first({col}::jsonb, ?::jsonpath) #>> '{{}}')"

    def json_array_contains(self, col: str) -> str:
        # reference: JSONB `?` operator; @> avoids the operator/paramstyle
        # clash (a literal `?` would collide with qmark translation)
        return f"(COALESCE({col}::jsonb -> ?, 'null'::jsonb) @> to_jsonb(?::text))"

    def fts_schema(self, fts_table: str, meta_table: str,
                   meta_index: str) -> str:
        return f"""
        CREATE TABLE {fts_table} (
            rowid BIGINT GENERATED ALWAYS AS IDENTITY PRIMARY KEY,
            text TEXT NOT NULL,
            ts tsvector GENERATED ALWAYS AS (to_tsvector('english', text)) STORED
        );
        CREATE INDEX idx_{fts_table}_ts ON {fts_table} USING GIN (ts);
        CREATE TABLE {meta_table} (
            rowid BIGINT PRIMARY KEY,
            artifact_id TEXT NOT NULL UNIQUE,
            asset_id TEXT NOT NULL,
            start_ms INTEGER NOT NULL,
            end_ms INTEGER NOT NULL,
            language TEXT,
            run_id TEXT NOT NULL
        );
        CREATE INDEX {meta_index} ON {meta_table}(asset_id, start_ms);
        """

    def fts_from(self, fts_table: str, meta_table: str) -> str:
        return (f"FROM {fts_table} f JOIN {meta_table} m ON m.rowid = f.rowid,"
                f" to_tsquery('english', ?) q")

    def fts_match_where(self, fts_table: str) -> str:
        return "f.ts @@ q"

    def fts_snippet(self, fts_table: str) -> str:
        # MinWords must stay BELOW MaxWords or PG errors ("MinWords should be
        # less than MaxWords"); the default MinWords is 15, above our 12
        return (f"ts_headline('english', f.text, q, 'StartSel={_SNIP_OPEN},"
                f" StopSel={_SNIP_CLOSE}, MinWords=5, MaxWords={_SNIP_WORDS}')")

    def fts_rank(self, fts_table: str) -> str:
        return "ts_rank(f.ts, q)"

    def fts_order_by_rank(self, fts_table: str) -> str:
        return "ts_rank(f.ts, q) DESC"  # ts_rank: higher = better

    def fts_score(self, raw_rank: float) -> float:
        return float(raw_rank)

    def fts_match_expr(self, terms: list[str]) -> str:
        # reference: q.replace(' ', ' & ') into to_tsquery
        # (find_within_video_service.py:139-197); terms are \w+-sanitized
        return " & ".join(terms)

    def ilike(self) -> str:
        return "ILIKE"

    def fts_vocab_setup(self, fts_table: str) -> list[str]:
        return []  # ts_stat needs no side table

    def fts_vocab_terms(self, fts_table: str) -> str:
        return (f"SELECT word, ndoc FROM"
                f" ts_stat('SELECT ts FROM {fts_table}')")

    def latest_run_per_language_clause(self) -> str:
        # reference: DISTINCT ON (payload_json->>'language') raw SQL
        # (artifact_repository.py:258-287)
        return (
            "run_id IN (SELECT DISTINCT ON"
            " (COALESCE(payload_json::jsonb->>'language','')) run_id"
            " FROM artifacts WHERE asset_id=? AND artifact_type=?"
            " ORDER BY COALESCE(payload_json::jsonb->>'language',''),"
            " created_at DESC, run_id DESC)"
        )

    def running_seconds_expr(self) -> str:
        return ("EXTRACT(EPOCH FROM (COALESCE(completed_at::timestamptz, now())"
                " - started_at::timestamptz))")


SQLITE = SqliteDialect()
POSTGRES = PostgresDialect()


def translate_qmark(sql: str, to: str = "%s") -> str:
    """Rewrite qmark placeholders to the target style, skipping string
    literals, double-quoted identifiers, and line/block comments. All
    first-party SQL is written qmark-style; the PG connection translates at
    execute time."""
    out: list[str] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch == "'":
            j = i + 1
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # escaped ''
                        j += 2
                        continue
                    break
                j += 1
            out.append(sql[i:j + 1]); i = j + 1
        elif ch == '"':
            j = sql.find('"', i + 1)
            j = n - 1 if j == -1 else j
            out.append(sql[i:j + 1]); i = j + 1
        elif ch == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            j = n - 1 if j == -1 else j
            out.append(sql[i:j + 1]); i = j + 1
        elif ch == "/" and sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            j = n - 2 if j == -1 else j
            out.append(sql[i:j + 2]); i = j + 2
        elif ch == "?":
            out.append(to); i += 1
        else:
            out.append(ch); i += 1
    return "".join(out)
