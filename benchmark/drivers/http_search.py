"""Open-loop semantic search over HTTP against the port's API server.

Set-up writes the seeded library (chunk rows in the port's SQLite schema,
made by the port's own migrations, and their vectors in the vector file
`SemanticIndex` reads), the seeded MiniLM checkpoint and its WordPiece
vocabulary, starts the server through the benchmark's launcher as its own
process, and warms it with searches (the model load on first use, the
corpus upload, the IVF build). This process is the load generator and
touches no card: the server is the only process on it.

The window offers `GET /api/v1/search?q=...&mode=semantic&top_k=10` at the
traffic's fixed rate: rate x seconds arrivals at uniform times (a Poisson
process conditioned on its count; the same times for every seed), each
timed from when it was due. A failed or unanswered request counts as
missing, infinitely late.

`correct` compares, on requests drawn from the seed once the window has
closed: each query's embedding as the server computed it against the
float32 reference (MiniLM with its own WordPiece); each returned hit's
score against the reference query's cosine with that slot's stored
vector; and, exactly, that the hits are the slots' own rows, in
descending order, `top_k` of them, no slot twice.
"""
from __future__ import annotations

import asyncio
import json
import math
import os
import random
import shutil
import signal
import socket
import sqlite3
import subprocess
import sys
import time
from urllib.parse import quote

import numpy as np

from benchmark import harness
from benchmark import weights as bench_weights
from benchmark.reference import minilm as ref_minilm
from benchmark.reference.precision import Arith

DIM = 384
CHECKED = ("embed_err", "score_err", "hit_faults")
SPECIALS = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]


# -- the library -------------------------------------------------------------------------


def _words(rng: np.random.Generator, n: int) -> list[str]:
    """n distinct pronounceable lower-case pseudo-words."""
    onsets = list("bcdfghjklmnprstvwz") + ["br", "ch", "st", "tr", "pl", "gr", "sh", "th"]
    vowels = ["a", "e", "i", "o", "u", "ai", "ou", "ee"]
    codas = ["", "", "n", "r", "s", "t", "l", "m"]
    out: dict[str, None] = {}
    while len(out) < n:
        k = int(rng.integers(1, 4))
        w = "".join(onsets[rng.integers(len(onsets))] + vowels[rng.integers(len(vowels))]
                    + codas[rng.integers(len(codas))] for _ in range(k))
        out.setdefault(w)
    return list(out)


class Library:
    """The seeded corpus: a vocabulary of pseudo-words drawn by Zipf's law,
    sentences of them, and chunks of `sentences_per_chunk` sentences (about
    400 characters), each with a clustered unit vector. The files live in
    `folder`, written once per seed and parameters."""

    def __init__(self, folder: str, seed: int, p: dict):
        self.folder, self.seed, self.p = folder, seed, p
        rng = np.random.default_rng([seed, 23])
        self.words = _words(rng, p["words"])
        zipf = 1.0 / np.arange(1, len(self.words) + 1) ** p["zipf_s"]
        self.word_p = zipf / zipf.sum()
        lens = rng.integers(p["sentence_words"][0], p["sentence_words"][1] + 1, p["sentences"])
        ids = rng.choice(len(self.words), int(lens.sum()), p=self.word_p)
        cuts = np.cumsum(lens)[:-1]
        self.sentences = [" ".join(self.words[i] for i in part) for part in np.split(ids, cuts)]
        self.db_path = os.path.join(folder, "library.db")
        self.index_dir = os.path.join(folder, "index")
        self.model_dir = os.path.join(folder, "models")
        self.chunk_sentences = None

    @property
    def vocab(self) -> list[str]:
        """BERT's layout (specials, the words, then single letters and
        '##' continuations of one to three letters) at the published size."""
        import itertools

        letters = "abcdefghijklmnopqrstuvwxyz"
        lines = SPECIALS + self.words + list(letters)
        for n in itertools.count(1):
            for combo in itertools.product(letters, repeat=n):
                if len(lines) >= self.p["vocab_size"]:
                    return lines
                lines.append("##" + "".join(combo))

    def text(self, slot: int) -> str:
        return " ".join(self.sentences[j] for j in self.chunk_sentences[slot])

    def vectors(self) -> np.ndarray:
        n = os.path.getsize(os.path.join(self.index_dir, "vectors.f16")) // (2 * DIM)
        return np.memmap(os.path.join(self.index_dir, "vectors.f16"), np.float16, "r",
                         shape=(n, DIM))

    def build(self) -> None:
        """Write the library unless this seed's is there already."""
        stamp = os.path.join(self.folder, "stamp.json")
        want = {"seed": self.seed, "p": self.p}
        if os.path.isfile(stamp):
            with open(stamp) as f:
                if json.load(f) == want:
                    self.chunk_sentences = np.load(os.path.join(self.folder, "chunks.npy"))
                    return
        shutil.rmtree(self.folder, ignore_errors=True)
        os.makedirs(self.index_dir)
        os.makedirs(os.path.join(self.model_dir, "minilm-l6"))
        p, n = self.p, self.p["chunks"]
        rng = np.random.default_rng([self.seed, 29])
        self.chunk_sentences = rng.integers(0, len(self.sentences), (n, p["sentences_per_chunk"]),
                                            dtype=np.int32)
        np.save(os.path.join(self.folder, "chunks.npy"), self.chunk_sentences)
        centers = rng.standard_normal((p["topics"], DIM), dtype=np.float32)
        with open(os.path.join(self.index_dir, "vectors.f16"), "wb") as f:
            for s in range(0, n, 65536):
                m = min(65536, n - s)
                v = centers[rng.integers(0, p["topics"], m)]
                v += p["topic_spread"] * rng.standard_normal((m, DIM), dtype=np.float32)
                v /= np.linalg.norm(v, axis=1, keepdims=True)
                f.write(v.astype(np.float16).tobytes())
        with open(os.path.join(self.index_dir, "meta.json"), "w") as f:
            json.dump({"dim": DIM, "model": "minilm-l6", "rows": n}, f)
        self._write_rows()
        self._write_model()
        with open(stamp, "w") as f:
            json.dump(want, f)

    def _write_rows(self) -> None:
        from eioku_tpu_torch.db.connection import connect
        from eioku_tpu_torch.db.migrations import run_migrations

        db = connect("sqlite:///" + self.db_path)
        run_migrations(db)
        db.close()
        per_video = self.p["chunks_per_video"]
        conn = sqlite3.connect(self.db_path)
        try:
            conn.execute("PRAGMA synchronous=OFF")
            conn.executemany(
                "INSERT INTO embedding_chunks (slot, artifact_id, asset_id, start_ms, end_ms,"
                " text, source, model, run_id) VALUES (?,?,?,?,?,?,?,?,?)",
                ((s, f"chunk-{s}", f"video-{s // per_video}", (s % per_video) * 29000,
                  (s % per_video) * 29000 + 29000, self.text(s), "transcript", "minilm-l6",
                  "benchmark") for s in range(self.p["chunks"])))
            conn.commit()
        finally:
            conn.close()

    def _write_model(self) -> None:
        import torch

        sd = bench_weights.minilm_weights(self.p["model"], self.seed, "cpu")
        torch.save(sd, os.path.join(self.model_dir, "minilm-l6", "pytorch_model.bin"))
        with open(os.path.join(self.model_dir, "vocab.txt"), "w") as f:
            f.write("\n".join(self.vocab) + "\n")

    def server_config(self) -> str:
        path = os.path.join(self.folder, "server.json")
        with open(path, "w") as f:
            json.dump({"paths": [], "database_url": "sqlite:///" + self.db_path,
                       "model_cache_dir": self.model_dir, "index_dir": self.index_dir,
                       "auto_discover": False, "semantic_search": True,
                       "visual_search": False}, f)
        return path

    def queries(self, rng: random.Random, n: int, words: tuple[int, int]) -> list[str]:
        nprng = np.random.default_rng(rng.getrandbits(64))
        out = []
        for _ in range(n):
            k = int(nprng.integers(words[0], words[1] + 1))
            out.append(" ".join(self.words[i] for i in nprng.choice(len(self.words), k,
                                                                     p=self.word_p)))
        return out


# -- the server and the load -------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Server:
    """The port's API server in its own process, through the launcher."""

    def __init__(self, lib: Library, folder: str, trace: bool, cpu: bool,
                 fault: str | None = None):
        self.port = _free_port()
        self.out = os.path.join(folder, "server_report.json")
        if os.path.exists(self.out):
            os.remove(self.out)
        env = dict(os.environ, PYTHONPATH=harness.ROOT)
        if cpu:
            env["EIOKU_FORCE_CPU"] = "1"
        cmd = [sys.executable, "-m", "benchmark.drivers.server", "--out", self.out]
        cmd += ["--trace"] if trace else []
        cmd += ["--fault", fault] if fault else []
        cmd += ["--", "--config", lib.server_config(), "--host", "127.0.0.1",
                "--port", str(self.port), "--no-discover"]
        self.log_path = os.path.join(folder, "server.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, cwd=harness.ROOT, env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)

    def signal(self, sig) -> None:
        self.proc.send_signal(sig)

    def tail(self, n: int = 4000) -> str:
        self.log.flush()
        with open(self.log_path) as f:
            return f.read()[-n:]

    def stop(self) -> dict:
        """End the server (SIGINT, then the launcher's report) and wait."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        if not os.path.isfile(self.out):
            raise RuntimeError("the server left no report:\n" + self.tail())
        with open(self.out) as f:
            return json.load(f)


async def fetch(port: int, path: str) -> tuple[int, bytes]:
    """One GET on a new connection (`Connection: close`): (status, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n\r\n"
                     .encode())
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


def search_path(q: str, top_k: int) -> str:
    return f"/api/v1/search?q={quote(q)}&mode=semantic&top_k={top_k}"


async def _open_loop(port: int, schedule: list[tuple[float, str]], top_k: int,
                     close_s: float, grace_s: float) -> list[dict]:
    """Send each (due offset, query) at its due time; time each from its due
    time; wait at most `grace_s` past `close_s` for the last answers."""
    loop = asyncio.get_running_loop()
    t0 = loop.time() + 0.05
    results: list[dict] = [{} for _ in schedule]

    async def one(i: int, due: float, q: str) -> None:
        sent = loop.time()
        rec = results[i]
        rec.update(q=q, due=due - t0, late=sent - due, sent_wall=time.time())
        try:
            status, body = await fetch(port, search_path(q, top_k))
            rec["status"] = status
            rec["body"] = json.loads(body) if status == 200 else None
        except (OSError, ValueError, IndexError) as e:
            rec["status"], rec["body"] = None, None
            rec["error"] = repr(e)
        rec["latency"] = loop.time() - due
        rec["done_wall"] = time.time()

    tasks = []
    for i, (off, q) in enumerate(schedule):
        due = t0 + off
        delay = due - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(one(i, due, q)))
    remaining = t0 + close_s + grace_s - loop.time()
    done, pending = await asyncio.wait(tasks, timeout=max(remaining, 0.1))
    for t in pending:
        t.cancel()
    for t in done:
        t.result()
    for rec in results:
        if "latency" not in rec:
            rec.update(status=None, body=None, latency=None, error="no answer")
    return results


def schedule(rng: random.Random, lib: Library, rate: float, seconds: float,
             words: tuple[int, int]) -> list[tuple[float, str]]:
    """round(rate x seconds) arrivals at uniform times in [0, seconds) (a
    Poisson process of that rate, given its count), each a Zipf query drawn
    from `rng`. The times are the same for every seed, so that the seed
    changes the queries and not the bursts that set the tail."""
    n = max(int(round(rate * seconds)), 1)
    arrivals = random.Random(f"arrivals {rate} {seconds}")
    times = sorted(arrivals.uniform(0, seconds) for _ in range(n))
    return list(zip(times, lib.queries(rng, n, words)))


def answered(rec: dict) -> bool:
    return rec.get("status") == 200 and rec.get("body") is not None


# -- the check ---------------------------------------------------------------------------------


def reference_model(lib: Library, quant: str | None = None) -> tuple:
    import torch

    sd = torch.load(os.path.join(lib.model_dir, "minilm-l6", "pytorch_model.bin"),
                    map_location="cpu", weights_only=True)
    return (ref_minilm.MiniLM({k: v.float() for k, v in sd.items()},
                              lib.p["model"]["num_attention_heads"], Arith(quant)),
            ref_minilm.WordPiece(lib.vocab))


def readings(sample: list[dict], embeddings: dict, lib: Library, top_k: int,
             ref, tok, control=None) -> dict:
    """embed_err: the largest 1 - cosine of a query's embedding against the
    reference's; score_err: the largest distance of a hit's score from the
    reference query's cosine with that slot's stored vector; hit_faults: the
    hits that are not their slot's row, out of order, repeated, or missing
    from top_k. With `control` (the reference in float8), the first two of
    the control in the program's place, under "control"."""
    import torch

    vecs = lib.vectors()
    out = {"embed_err": 0.0, "score_err": 0.0, "hit_faults": 0.0, "requests": 0, "hits": 0}
    ctl = {"embed_err": 0.0, "score_err": 0.0, "hit_faults": 0.0}
    with torch.no_grad():
        for rec in sample:
            q = rec["q"]
            want = ref.embed(tok.encode(q)).double()
            got = embeddings.get(q)
            hits = rec["body"]["results"]
            slots = []
            for h in hits:
                slot = int(h["artifact_id"].split("-", 1)[1])
                ok = h["text"] == lib.text(slot) and 0 <= slot < len(vecs)
                slots.append(slot if ok else None)
                out["hit_faults"] += 0 if ok else 1
            scores = [h["score"] for h in hits]
            out["hit_faults"] += sum(1 for a, b in zip(scores, scores[1:]) if b > a)
            out["hit_faults"] += max(top_k - len(hits), 0)
            good = [s for s in slots if s is not None]
            out["hit_faults"] += len(good) - len(set(good))
            v = torch.from_numpy(np.asarray(vecs[good], np.float64))
            v = v / v.norm(dim=1, keepdim=True)
            ref_scores = v @ want
            sides = [(out, None if got is None else torch.tensor(got, dtype=torch.float64),
                      [h["score"] for h, s in zip(hits, slots) if s is not None])]
            if control is not None:
                qc = control.embed(tok.encode(q)).double()
                sides.append((ctl, qc, (v @ (qc / qc.norm())).tolist()))
            for r, emb, sc in sides:
                if emb is None:
                    r["embed_err"] = math.inf
                    continue
                cos = float(emb @ want / (emb.norm() * want.norm()))
                r["embed_err"] = max(r["embed_err"], 1.0 - cos)
                if sc:
                    r["score_err"] = max(r["score_err"], float(
                        (torch.tensor(sc, dtype=torch.float64) - ref_scores).abs().max()))
            out["requests"] += 1
            out["hits"] += len(hits)
    if control is not None:
        out["control"] = ctl
    return out


# -- one run ---------------------------------------------------------------------------------


def _settings(cell: harness.Cell, rehearse: bool) -> tuple[dict, dict]:
    lib_p = {**cell.traffic["library"], "model": cell.config["config"]}
    traffic = dict(cell.traffic)
    if rehearse:
        lib_p.update(cell.traffic["rehearse"].get("library", {}))
        traffic.update({k: v for k, v in cell.traffic["rehearse"].items() if k != "library"})
    return lib_p, traffic


def _warm(server: Server, lib: Library, rng: random.Random, traffic: dict) -> None:
    """Searches one at a time until the first answers (model load, corpus
    upload, IVF build), then `warm_searches` more."""
    deadline = time.monotonic() + traffic["startup_timeout_s"]
    queries = lib.queries(rng, int(traffic["warm_searches"]) + 1, tuple(traffic["query_words"]))
    first = True
    while True:
        if server.proc.poll() is not None:
            raise RuntimeError("the server exited during set-up:\n" + server.tail())
        try:
            status, _ = asyncio.run(fetch(server.port, search_path(queries[0], traffic["top_k"])))
            if status != 200:
                raise RuntimeError(f"warm-up search answered {status}:\n" + server.tail())
            harness.log(f"set-up: first search answered at {harness.process_age_s():.2f} s")
            break
        except OSError:
            if time.monotonic() > deadline:
                raise RuntimeError("the server did not answer in time:\n" + server.tail())
            time.sleep(0.1 if first else 0.25)
    for q in queries[1:]:
        status, _ = asyncio.run(fetch(server.port, search_path(q, traffic["top_k"])))
        if status != 200:
            raise RuntimeError(f"warm-up search answered {status}:\n" + server.tail())


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, rehearse: bool,
        fault: str | None = None) -> tuple[dict, dict]:
    """One run of a search cell: (result, checks)."""
    lib_p, traffic = _settings(cell, rehearse)
    folder = os.path.join(harness.CACHE_DIR, cell.name)
    os.makedirs(folder, exist_ok=True)
    lib = Library(os.path.join(folder, "library"), seed, lib_p)
    lib.build()
    harness.log(f"set-up: library ready at {harness.process_age_s():.2f} s")
    rng = random.Random(seed)
    top_k = int(traffic["top_k"])
    words = tuple(traffic["query_words"])
    server = Server(lib, folder, trace, cpu=rehearse, fault=fault)
    try:
        _warm(server, lib, rng, traffic)
        harness.log(f"set-up: server warm at {harness.process_age_s():.2f} s")
        plan = schedule(rng, lib, float(traffic["rate_per_s"]), seconds, words)
        server.signal(signal.SIGUSR1)  # the window starts: reset the peak
        setup_s = harness.process_age_s()
        results = asyncio.run(_open_loop(server.port, plan, top_k, seconds,
                                         float(traffic["grace_s"])))
        if trace and not rehearse:  # the profiler's slice, after the window
            server.signal(signal.SIGUSR2)
            slice_plan = schedule(rng, lib, float(traffic["rate_per_s"]),
                                  float(traffic["profile_s"]), words)
            asyncio.run(_open_loop(server.port, slice_plan, top_k, float(traffic["profile_s"]),
                                   float(traffic["grace_s"])))
            server.signal(signal.SIGUSR2)
            asyncio.run(fetch(server.port, search_path(slice_plan[0][1], top_k)))
    finally:
        report = server.stop()
    if report["forbidden"]:
        harness.log(f"the server process loaded {report['forbidden']}")
        sys.exit(4)
    failed = [r for r in results if not answered(r)]
    lat = [r["latency"] if answered(r) else None for r in results]
    late = sorted(r.get("late", 0.0) for r in results)
    harness.log(f"window: {len(results)} requests due over {seconds} s at "
                f"{traffic['rate_per_s']}/s; {len(failed)} failed or unanswered; "
                f"generator lateness p50 {late[len(late) // 2] * 1e3:.3f} ms, max "
                f"{late[-1] * 1e3:.3f} ms; latency p50 {harness.percentile(lat, 50) * 1e3:.3f} ms "
                f"p95 {harness.percentile(lat, 95) * 1e3:.3f} ms over all {len(lat)} requests")
    for r in failed[:3]:
        harness.log(f"failed request: {r.get('status')} {r.get('error', '')}")
    ok = [r for r in results if answered(r)]
    sample = random.Random(seed ^ 0x5EED).sample(ok, min(int(traffic["check_requests"]), len(ok)))
    t = time.perf_counter()
    ref, tok = reference_model(lib)
    r = readings(sample, report["embeddings"], lib, top_k, ref, tok)
    harness.log(f"check: {r['requests']} requests drawn from the seed, {r['hits']} hits; the "
                f"reference took {time.perf_counter() - t:.1f} s")
    limits = cell.config["limits"]
    checks = {k: (r[k], limits[k]) for k in CHECKED}
    checks["unchecked"] = (float(r["requests"] == 0), 0.0)
    if trace:
        metrics = harness.read_layers(cell, {
            "server": report, "requests": results, "window_s": seconds,
            "tokens": [len(tok.encode(x["q"])) for x in ok], "profile": report.get("profile")})
    else:
        metrics = {"search_p95_ms": harness.percentile(lat, 95) * 1e3, "setup_s": setup_s}
    device = {"platform": "cpu", "kind": "rehearsal", "count": 0, "memory_peak_bytes": 0} \
        if rehearse else {"platform": "gpu", "kind": report["kind"], "count": cell.chips,
                          "memory_peak_bytes": report["memory_peak_bytes"]}
    return harness.result_line(cell, checks, len(results), len(failed), metrics, device,
                               report.get("profile")), checks


def sweep(cell: harness.Cell, seed: int, seconds: float, rates: list[float]) -> list[dict]:
    """Open-loop windows at each rate against one warm server: completed
    rate, latency quantiles, and whether the backlog grew (the last fifth's
    median latency against the first fifth's)."""
    lib_p, traffic = _settings(cell, rehearse=False)
    folder = os.path.join(harness.CACHE_DIR, cell.name)
    os.makedirs(folder, exist_ok=True)
    lib = Library(os.path.join(folder, "library"), seed, lib_p)
    lib.build()
    rng = random.Random(seed)
    server = Server(lib, folder, trace=False, cpu=False)
    rows = []
    try:
        _warm(server, lib, rng, traffic)
        for rate in rates:
            plan = schedule(rng, lib, rate, seconds, tuple(traffic["query_words"]))
            res = asyncio.run(_open_loop(server.port, plan, int(traffic["top_k"]), seconds,
                                         float(traffic["grace_s"])))
            lat = [x["latency"] if answered(x) else None for x in res]
            fifth = max(len(res) // 5, 1)
            first = harness.percentile(lat[:fifth], 50)
            last = harness.percentile(lat[-fifth:], 50)
            end = max((x["done_wall"] for x in res if "done_wall" in x), default=0.0)
            start = min(x["sent_wall"] for x in res)
            row = {"rate": rate, "requests": len(res),
                   "failed": sum(1 for x in res if not answered(x)),
                   "completed_per_s": sum(1 for x in res if answered(x)) / max(end - start, 1e-9),
                   "p50_ms": harness.percentile(lat, 50) * 1e3,
                   "p95_ms": harness.percentile(lat, 95) * 1e3,
                   "first_fifth_p50_ms": first * 1e3, "last_fifth_p50_ms": last * 1e3}
            harness.log(f"sweep {row}")
            rows.append(row)
    finally:
        server.stop()
    return rows


def calibrate(cell: harness.Cell, seeds: list[int], seconds: float) -> list[dict]:
    """The program's readings and the control's (the reference in float8 in
    its place) on each seed's library and queries, at the cell's rate."""
    rows = []
    for seed in seeds:
        lib_p, traffic = _settings(cell, rehearse=False)
        folder = os.path.join(harness.CACHE_DIR, cell.name)
        os.makedirs(folder, exist_ok=True)
        lib = Library(os.path.join(folder, "library"), seed, lib_p)
        lib.build()
        rng = random.Random(seed)
        server = Server(lib, folder, trace=False, cpu=False)
        try:
            _warm(server, lib, rng, traffic)
            plan = schedule(rng, lib, float(traffic["rate_per_s"]), seconds,
                            tuple(traffic["query_words"]))
            res = asyncio.run(_open_loop(server.port, plan, int(traffic["top_k"]), seconds,
                                         float(traffic["grace_s"])))
        finally:
            report = server.stop()
        ok = [x for x in res if answered(x)]
        sample = random.Random(seed ^ 0x5EED).sample(ok, min(int(traffic["check_requests"]),
                                                            len(ok)))
        ref, tok = reference_model(lib)
        control, _ = reference_model(lib, "fp8")
        r = readings(sample, report["embeddings"], lib, int(traffic["top_k"]), ref, tok,
                     control=control)
        row = {"seed": seed, "requests": len(res), "failed": len(res) - len(ok),
               **{k: r[k] for k in CHECKED + ("hits", "control")}}
        harness.log(f"calibration {row}")
        rows.append(row)
    return rows
