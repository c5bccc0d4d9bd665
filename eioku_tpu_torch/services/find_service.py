"""Within-video keyword find over FTS projections.

Copy of eioku_tpu/services/find_service.py for the PyTorch port.

Capability parity: backend/src/services/find_within_video_service.py:27-435:
searches transcript_fts + ocr_fts with snippets, direction-aware (next occurrence
after t / previous before t), LIKE fallback when the FTS query yields nothing,
per-source LIMIT 10, results merged and sorted by start time.

Unlike the reference, jump/find here use the projection tables (indexed by
(asset_id, start_ms)) instead of loading all artifacts and filtering in Python —
see the reference's own perf note at jump_navigation_service.py:31-240.
"""
from __future__ import annotations

import re

from eioku_tpu_torch.db.connection import Database

_PER_SOURCE_LIMIT = 10


def _fts_query(query: str, dialect) -> str:
    """Sanitize a user query into an AND-of-terms match expression in the
    dialect's syntax: FTS5 `"a" AND "b"` vs PG to_tsquery `a & b` (the
    reference does q.replace(' ', ' & ') for PG,
    find_within_video_service.py:139-197)."""
    terms = re.findall(r"\w+", query, flags=re.UNICODE)
    return dialect.fts_match_expr(terms) if terms else ""


class FindWithinVideoService:
    def __init__(self, db: Database):
        self.db = db

    def find(self, asset_id: str, query: str, from_ms: int = 0,
             direction: str = "next", limit: int = _PER_SOURCE_LIMIT) -> list[dict]:
        if not query or not query.strip():
            return []
        results = []
        for source, fts, meta in (("transcript", "transcript_fts", "transcript_fts_meta"),
                                  ("ocr", "ocr_fts", "ocr_fts_meta")):
            results.extend(self._search(source, fts, meta, asset_id, query,
                                        from_ms, direction, limit))
        reverse = direction == "prev"
        results.sort(key=lambda m: m["jump_to"]["start_ms"], reverse=reverse)
        return results

    def search_library(self, query: str, limit: int = 10,
                       asset_id: str | None = None) -> list[dict]:
        """Library-wide keyword search across transcript + OCR FTS, ordered by
        bm25 relevance (beyond the reference: its find is per-video and
        time-ordered). Result shape matches SemanticIndex.search so the
        /search endpoint can serve keyword and hybrid modes."""
        d = self.db.dialect
        match = _fts_query(query, d)
        if not match:
            return []
        out: list[dict] = []
        for source, fts, meta in (("transcript", "transcript_fts",
                                   "transcript_fts_meta"),
                                  ("ocr", "ocr_fts", "ocr_fts_meta")):
            where_asset = " AND m.asset_id = ?" if asset_id else ""
            # ONE query param in both dialects, bound first: SQLite in the
            # MATCH predicate, PG in the to_tsquery(?) in FROM (which
            # precedes WHERE in bind order)
            params: tuple = (match,) + ((asset_id,) if asset_id else ()) + (limit,)
            try:
                rows = self.db.query(
                    f"SELECT m.artifact_id, m.asset_id, m.start_ms, m.end_ms,"
                    f" {d.fts_rank(fts)} AS rank,"
                    f" {d.fts_snippet(fts)} AS snip"
                    f" {d.fts_from(fts, meta)}"
                    f" WHERE {d.fts_match_where(fts)}{where_asset}"
                    f" ORDER BY {d.fts_order_by_rank(fts)} LIMIT ?", params)
            except Exception:
                continue
            out.extend({
                "score": round(d.fts_score(r["rank"]), 4),
                "video_id": r["asset_id"],
                "text": r["snip"],
                "source": source,
                "artifact_id": r["artifact_id"],
                "jump_to": {"start_ms": r["start_ms"], "end_ms": r["end_ms"]},
            } for r in rows)
        out.sort(key=lambda m: m["score"], reverse=True)
        return out[:limit]

    def suggest_alternatives(self, query: str, limit: int = 5) -> list[str]:
        """Did-you-mean terms for a query that returned nothing (spec req 2.4,
        .kiro/specs/semantic-video-search/requirements.md: 'provide feedback
        suggesting alternative search terms').

        Candidates come from what the library actually contains — the FTS
        vocabulary (fts5vocab / ts_stat via the dialect), object labels, and
        topics — ranked by string similarity to the query terms; when nothing
        is close, the most frequent terms are offered as discovery hints."""
        import difflib

        q_terms = [t.lower() for t in re.findall(r"\w+", query)]
        cands: dict[str, int] = {}
        for fts in ("transcript_fts", "ocr_fts"):
            try:
                for ddl in self.db.dialect.fts_vocab_setup(fts):
                    self.db.execute(ddl)
                # cap by document frequency: a large library's vocabulary is
                # 100k+ terms, and this runs inside the API event loop — the
                # top few thousand cover every plausible suggestion
                rows = self.db.query(
                    f"SELECT * FROM ({self.db.dialect.fts_vocab_terms(fts)})"
                    " AS vocab ORDER BY 2 DESC LIMIT 4000")  # PG needs alias
                for r in rows:
                    term = str(r[0]).lower()
                    if len(term) >= 3:
                        cands[term] = cands.get(term, 0) + int(r[1])
            except Exception:
                continue
        for sql in ("SELECT label, COUNT(*) FROM object_labels GROUP BY label",
                    "SELECT label, COUNT(*) FROM topics GROUP BY label"):
            try:
                for r in self.db.query(sql):
                    term = str(r[0]).lower()
                    cands[term] = cands.get(term, 0) + int(r[1])
            except Exception:
                continue
        for t in q_terms:  # these already matched nothing
            cands.pop(t, None)
        if not cands:
            return []

        def closeness(term: str) -> float:
            return max((difflib.SequenceMatcher(None, t, term).ratio()
                        for t in q_terms), default=0.0)

        scored = [(closeness(t), n, t) for t, n in cands.items()]
        close = sorted((s for s in scored if s[0] >= 0.6), reverse=True)
        if close:
            return [t for _, _, t in close[:limit]]
        # nothing similar: most frequent library terms as discovery hints
        return [t for _, _, t in
                sorted(scored, key=lambda s: (-s[1], s[2]))[:limit]]

    def _search(self, source: str, fts_table: str, meta_table: str, asset_id: str,
                query: str, from_ms: int, direction: str, limit: int) -> list[dict]:
        d = self.db.dialect
        match = _fts_query(query, d)
        time_op = ">=" if direction == "next" else "<"
        order = "ASC" if direction == "next" else "DESC"
        rows: list = []
        if match:
            try:
                rows = self.db.query(
                    f"SELECT m.artifact_id, m.start_ms, m.end_ms, m.language,"
                    f" {d.fts_snippet(fts_table)} AS snip"
                    f" {d.fts_from(fts_table, meta_table)}"
                    f" WHERE {d.fts_match_where(fts_table)} AND m.asset_id = ?"
                    f" AND m.start_ms {time_op} ?"
                    f" ORDER BY m.start_ms {order} LIMIT ?",
                    (match, asset_id, from_ms, limit),
                )
            except Exception:
                rows = []
        if not rows:
            # Substring fallback, mirrors the reference's ILIKE fallback
            # (find_within_video_service.py:171-196).
            rows = self.db.query(
                f"SELECT m.artifact_id, m.start_ms, m.end_ms, m.language,"
                f" f.text AS snip"
                f" FROM {fts_table} f JOIN {meta_table} m ON m.rowid = f.rowid"
                f" WHERE f.text {d.ilike()} ? AND m.asset_id = ?"
                f" AND m.start_ms {time_op} ?"
                f" ORDER BY m.start_ms {order} LIMIT ?",
                (f"%{query}%", asset_id, from_ms, limit),
            )
        return [
            {
                "artifact_id": r["artifact_id"],
                "source": source,
                "snippet": r["snip"],
                "language": r["language"],
                "jump_to": {"start_ms": r["start_ms"], "end_ms": r["end_ms"]},
            }
            for r in rows
        ]
