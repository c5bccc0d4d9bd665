/* Eioku SPA — no-build vanilla JS client for the eioku-tpu API.
 * Capability parity with the reference React frontend
 * (frontend/src/: VideoGallery, VideoPlayer with canvas
 * overlays and 7 artifact tabs, JumpNavigationControl, TranscriptViewer with
 * run selector and synced highlight, TaskStatusViewer with retry,
 * MetadataViewer with location) plus the semantic search the reference never
 * shipped. */
"use strict";
const API = "/api/v1";
const $ = (id) => document.getElementById(id);
const state = {
  video: null, tab: "transcript", artifacts: {}, runs: [], run: null,
  overlays: { objects: false, faces: false, ocr: false }, tasksTimer: null,
  tasksSource: null,
  overlayRaf: null, videoPaths: {},
};

async function api(path, opts) {
  const r = await fetch(API + path, opts);
  if (!r.ok) throw new Error(`${r.status} ${await r.text()}`);
  return r.json();
}
const fmtMs = (ms) => {
  const s = Math.floor(ms / 1000);
  return `${Math.floor(s / 60)}:${String(s % 60).padStart(2, "0")}`;
};
const esc = (t) => { const d = document.createElement("div"); d.textContent = t ?? ""; return d.innerHTML; };

/* ---------- people (cross-video face identities) ---------- */
async function togglePeople() {
  const panel = $("people-panel");
  if (!panel.classList.contains("hidden")) {
    panel.classList.add("hidden");
    return;
  }
  panel.classList.remove("hidden");
  panel.innerHTML = "<em>Clustering faces…</em>";
  try {
    const { people } = await api("/people");
    if (!people.length) {
      panel.innerHTML = "<p>No face identities yet — run face detection " +
        "with <code>{\"embeddings\": true}</code>.</p>";
      return;
    }
    panel.innerHTML = "<h3>People</h3>" + people.map(p => {
      const o = p.occurrences[0];
      return `
      <div class="person" data-pid="${p.person_id}">
        <img class="mini-thumb" loading="lazy" alt="" src="${API}/videos/${
          o.video_id}/thumbnail?at_ms=${o.first_ms}"
          onerror="this.style.display='none'">
        <strong>${esc(p.person_id.replace("_", " "))}</strong>
        <span class="meta">${p.total_faces} faces · ${p.video_count} video${
          p.video_count > 1 ? "s" : ""}</span>
        <div class="occ">${p.occurrences.map(o => `
          <a href="#" data-vid="${o.video_id}" data-ms="${o.first_ms}">
            ${esc(state.videoPaths[o.video_id] || o.video_id.slice(0, 8))}
            @ ${fmtMs(o.first_ms)}</a>`).join(" · ")}</div>
      </div>`;
    }).join("");
    for (const a of panel.querySelectorAll(".occ a"))
      a.onclick = (e) => { e.preventDefault();
                           openVideo(a.dataset.vid, +a.dataset.ms); };
  } catch (e) {
    panel.innerHTML = `<p>People unavailable: ${esc(e.message)}</p>`;
  }
}

/* ---------- gallery ---------- */
async function loadGallery() {
  // sort + filename filter are SERVER-side (spec req 8.4): the SQL sorts/
  // filters so a 10k-video library doesn't ship to the browser to be sorted
  const [sortBy, order] = ($("gallery-sort")?.value || "created_at:desc").split(":");
  const q = $("gallery-filter")?.value.trim();
  const params = new URLSearchParams({ sort_by: sortBy, order });
  if (q) params.set("q", q);
  const { videos } = await api(`/videos?${params}`);
  for (const v of videos)  // filename map for search-result cards
    state.videoPaths[v.id] = v.path.split("/").pop();
  $("gallery").innerHTML = videos.map(v => `
    <div class="card" data-id="${v.id}">
      <img class="thumb" loading="lazy" alt=""
        src="${API}/videos/${v.id}/thumbnail" onerror="this.style.display='none'">
      <div class="path">${esc(v.path.split("/").pop())}</div>
      <div class="meta">${v.duration_ms ? fmtMs(v.duration_ms) : "—"} ·
        ${esc(v.status)} · ${(v.size_bytes / 1e6).toFixed(1)} MB</div>
    </div>`).join("") || "<p>No videos discovered yet.</p>";
  for (const card of document.querySelectorAll("#gallery .card"))
    card.onclick = () => openVideo(card.dataset.id);
  api("/stats").then(s => {
    $("library-stats").innerHTML =
      `<span class="chip">${s.videos.total} videos</span>` +
      `<span class="chip">${s.videos.duration_hours} h</span>` +
      `<span class="chip">${s.artifacts.total} artifacts</span>` +
      (s.semantic_index.chunks
        ? `<span class="chip">${s.semantic_index.chunks} indexed chunks</span>` : "");
  }).catch(() => {});
}

/* ---------- semantic search ---------- */
const previewTimers = new Set();  // cleared on re-render: removed nodes
                                  // never fire mouseleave
function clearPreviewTimers() {
  for (const t of previewTimers) clearInterval(t);
  previewTimers.clear();
}
async function doSearch() {
  const q = $("search-input").value.trim();
  if (!q) return;
  const box = $("search-results");
  clearPreviewTimers();
  box.classList.remove("hidden");
  box.innerHTML = "<em>Searching…</em>";
  try {
    const rr = $("search-rerank")?.checked ? "&rerank=1" : "";
    const mode = $("search-mode")?.value || "semantic";
    const { results, suggestions, reranked } = await api(
      `/search?q=${encodeURIComponent(q)}&top_k=10&mode=${mode}${rr}`);
    let empty = "<p>No matches.</p>";
    if (suggestions?.length)  // spec req 2.4: offer alternative terms
      empty += `<p class="suggest">Try: ${suggestions.map(s =>
        `<a href="#" class="suggest-term">${esc(s)}</a>`).join(" · ")}</p>`;
    box.innerHTML = `<h3>Results for “${esc(q)}”</h3>` + (results.map(r => `
      <div class="seg" data-vid="${r.video_id}" data-ms="${r.jump_to.start_ms}">
        <img class="mini-thumb" loading="lazy" alt="" src="${API}/videos/${
          r.video_id}/thumbnail?at_ms=${r.jump_to.start_ms}"
          onerror="this.style.display='none'">
        <span class="t">${fmtMs(r.jump_to.start_ms)}</span>
        <span class="fname">${esc(state.videoPaths[r.video_id] || "")}</span>
        ${esc(r.text.slice(0, 140))}
        <span class="chip">${(reranked && r.rerank_score !== undefined
          ? r.rerank_score : r.score).toFixed(3)}</span>
      </div>`).join("") || empty);
    for (const el of box.querySelectorAll(".seg")) {
      el.onclick = () => { clearPreviewTimers();
                           openVideo(el.dataset.vid, +el.dataset.ms); };
      // hover preview (spec req 3.3): animate the scene by cycling the
      // thumbnail through the seconds after the match
      const img = el.querySelector(".mini-thumb");
      if (img) {
        let timer = null, k = 0;
        const stop = () => {
          clearInterval(timer); previewTimers.delete(timer); k = 0;
          img.src = `${API}/videos/${el.dataset.vid}/thumbnail?at_ms=${el.dataset.ms}`;
        };
        el.onmouseenter = () => {
          timer = setInterval(() => {
            k = (k + 1) % 4;
            img.src = `${API}/videos/${el.dataset.vid}/thumbnail?at_ms=${
              +el.dataset.ms + k * 1000}`;
          }, 600);
          previewTimers.add(timer);
        };
        el.onmouseleave = stop;
      }
    }
    for (const a of box.querySelectorAll(".suggest-term"))
      a.onclick = (e) => { e.preventDefault();
        $("search-input").value = a.textContent; doSearch(); };
  } catch (e) { box.innerHTML = `<p>Search unavailable: ${esc(e.message)}</p>`; }
}

/* ---------- player ---------- */
async function openVideo(id, seekMs, fromHistory) {
  state.video = await api(`/videos/${id}`);
  state.artifacts = {}; state.runs = []; state.run = null;
  $("gallery-view").classList.add("hidden");
  $("player-view").classList.remove("hidden");
  const video = $("video");
  video.src = `${API}/videos/${id}/stream`;
  // native captions from the transcript (server renders WebVTT with the
  // same selection policy as the Transcript tab, speaker labels included)
  video.querySelectorAll("track").forEach(t => t.remove());
  const track = document.createElement("track");
  track.kind = "captions";
  track.label = "Transcript";
  track.srclang = "en";
  track.default = true;  // non-default tracks stay disabled: never fetched
  track.src = `${API}/videos/${id}/subtitles?format=vtt&with_speakers=1`;
  video.appendChild(track);
  if (seekMs != null) video.currentTime = seekMs / 1000;
  if (!fromHistory) history.pushState({ video: id }, "", `#v=${id}`);
  selectTab(state.tab);
  loadJumpOptions();
  loadStoryboard(id);
  if (state.overlayRaf) cancelAnimationFrame(state.overlayRaf);
  overlayLoop();
}
function closeVideo(fromHistory) {
  $("video").pause();
  $("video").removeAttribute("src");
  if (state.overlayRaf) { cancelAnimationFrame(state.overlayRaf); state.overlayRaf = null; }
  state.video = null;
  $("player-view").classList.add("hidden");
  $("gallery-view").classList.remove("hidden");
  stopTaskUpdates();
  if (fromHistory !== true) history.pushState({}, "", "#");
  loadGallery();
}
const seek = (ms) => { $("video").currentTime = ms / 1000; $("video").play(); };

/* ---------- artifacts ---------- */
const TAB_TYPE = { transcript: "transcript.segment", scenes: "scene",
  objects: "object.detection", ocr: "ocr.text", places: "place.classification",
  faces: "face.detection", speakers: "speaker.turn", metadata: "video.metadata" };

async function fetchArtifacts(type, runId) {
  const key = `${type}:${runId || ""}`;
  if (!state.artifacts[key]) {
    let q = runId ? `&run_id=${runId}` : "";
    if (type === "transcript.segment") q += "&with_speakers=1";
    state.artifacts[key] = (await api(
      `/videos/${state.video.id}/artifacts?type=${type}${q}`)).artifacts;
  }
  return state.artifacts[key];
}

async function selectTab(tab) {
  state.tab = tab;
  for (const b of document.querySelectorAll("#tabs button"))
    b.classList.toggle("active", b.dataset.tab === tab);
  const content = $("tab-content");
  content.innerHTML = "<em>Loading…</em>";
  if (tab === "tasks") { $("run-selector-wrap").classList.add("hidden");
    startTaskUpdates(); return renderTasks(); }
  stopTaskUpdates();
  const type = TAB_TYPE[tab];
  const { runs } = await api(`/videos/${state.video.id}/runs?artifact_type=${type}`);
  state.runs = runs;
  const wrap = $("run-selector-wrap");
  if (runs.length > 1) {
    wrap.classList.remove("hidden");
    $("run-selector").innerHTML = runs.map(r =>
      `<option value="${r.run_id}">${r.run_id.slice(0, 8)} · ${r.model_profile}` +
      `${r.language ? " · " + r.language : ""} · ${r.artifact_count}</option>`).join("");
    state.run = $("run-selector").value;
  } else { wrap.classList.add("hidden"); state.run = null; }
  renderTab();
}

async function renderTab() {
  const tab = state.tab, content = $("tab-content");
  if (tab === "topics") return renderTopics();
  const type = TAB_TYPE[tab];
  const arts = await fetchArtifacts(type, state.run);
  if (tab === "metadata") return renderMetadata(arts);
  if (!arts.length) { content.innerHTML = "<p>No artifacts.</p>"; return; }
  if (tab === "objects") return renderObjectGroups(arts);
  content.innerHTML = arts.map((a, i) => {
    const p = a.payload_json;
    let body;
    if (tab === "transcript") body = (p.speaker
      ? `<span class="chip">${esc(p.speaker)}</span> ` : "") + esc(p.text)
      // spec req 5.5: flag uncertain transcriptions
      + ((p.confidence ?? 1) < 0.5
        ? ` <span class="chip uncertain" title="low transcription confidence">low conf.</span>` : "");
    else if (tab === "scenes") body = `Scene ${p.scene_index} · ${fmtMs(p.duration_ms)}`
      + (p.score ? ` · score ${p.score}` : "");
    else if (tab === "ocr") body = `${esc(p.text)} <span class="chip">${((p.confidence || 0) * 100).toFixed(0)}%</span>`;
    else if (tab === "places") body = p.predictions.slice(0, 3).map(x =>
      `${esc(x.label)} <span class="chip">${(x.confidence * 100).toFixed(0)}%</span>`).join(" ");
    else if (tab === "speakers") body = `${esc(p.label)} · ${fmtMs(p.end_ms - p.start_ms)}`
      + ` <span class="chip">${((p.confidence || 0) * 100).toFixed(0)}%</span>`;
    else if (tab === "faces") body = `face${p.cluster_id ? " · " + esc(p.cluster_id) : ""}`
      + ` <span class="chip">${(p.confidence * 100).toFixed(0)}%</span>`;
    return `<div class="seg" data-ms="${a.span_start_ms}" data-i="${i}">
      <span class="t">${fmtMs(a.span_start_ms)}</span>${body}</div>`;
  }).join("");
  for (const el of content.querySelectorAll(".seg"))
    el.onclick = () => seek(+el.dataset.ms);
}

async function renderTopics() {
  /* Discovered topics for this video (GET /videos/{id}/topics) — the
   * reference shipped only the topics table (migration 3b330dae216d); here
   * the TF-IDF topic service fills it and the SPA surfaces it. */
  const content = $("tab-content");
  const { topics } = await api(`/videos/${state.video.id}/topics`);
  if (!topics.length) {
    content.innerHTML =
      "<p>No topics yet — they appear once a transcript is indexed.</p>";
    return;
  }
  content.innerHTML = topics.map(t =>
    `<div class="seg"><span class="chip">${(t.score * 100).toFixed(0)}%</span>
     ${esc(t.label)}</div>`).join("");
}

function renderObjectGroups(arts) {
  /* Grouped-by-label objects view with counts (reference
   * ObjectDetectionViewer.tsx:108 groupedByLabel), each group expandable to
   * its timestamped detections. */
  const groups = {};
  for (const a of arts)
    (groups[a.payload_json.label] ||= []).push(a);
  const order = Object.entries(groups).sort((x, y) => y[1].length - x[1].length);
  $("tab-content").innerHTML = order.map(([label, items], gi) => `
    <details class="obj-group" ${gi === 0 ? "open" : ""}>
      <summary>${esc(label)} <span class="chip">${items.length}</span></summary>
      ${items.map(a => `
        <div class="seg" data-ms="${a.span_start_ms}">
          <span class="t">${fmtMs(a.span_start_ms)}</span>
          <span class="chip">${(a.payload_json.confidence * 100).toFixed(0)}%</span>
        </div>`).join("")}
    </details>`).join("");
  for (const el of $("tab-content").querySelectorAll(".seg"))
    el.onclick = () => seek(+el.dataset.ms);
}

function renderMetadata(arts) {
  const content = $("tab-content");
  if (!arts.length) { content.innerHTML = "<p>No metadata.</p>"; return; }
  const p = arts[0].payload_json;
  const rows = [["Duration", p.duration_ms ? fmtMs(p.duration_ms) : null],
    ["Resolution", p.width ? `${p.width}×${p.height}` : null], ["FPS", p.fps],
    ["Codec", p.codec], ["Audio", p.audio_codec], ["Container", p.container],
    ["Camera", p.camera_make ? `${p.camera_make} ${p.camera_model || ""}`.trim() : null],
    ["Created", p.create_date],
    ["GPS", p.gps ? `${p.gps.latitude.toFixed(4)}, ${p.gps.longitude.toFixed(4)}` : null]]
    .filter(([, v]) => v != null);
  content.innerHTML = `<table class="kv">${rows.map(([k, v]) =>
    `<tr><td>${k}</td><td>${esc(String(v))}</td></tr>`).join("")}</table>
    <div id="location-info"></div>`;
  api(`/videos/${state.video.id}/location`).then(loc => {
    $("location-info").innerHTML =
      `<p>📍 ${[loc.city, loc.state, loc.country].filter(Boolean).join(", ") || "unknown"}</p>`;
  }).catch(() => {});
}

/* ---------- tasks ---------- */
async function renderTasks() {
  const { tasks } = await api(`/videos/${state.video.id}/tasks`);
  $("tab-content").innerHTML = tasks.map(t => `
    <div class="seg">
      ${esc(t.task_type)}${t.language ? " (" + t.language + ")" : ""}
      <span class="chip ${t.status}">${t.status}</span>
      ${t.running_time_s != null ? `<span class="chip">${t.running_time_s.toFixed(1)}s</span>` : ""}
      ${t.status === "running" && t.progress != null
        ? `<span class="pbar"><span class="pfill" style="width:${Math.round(t.progress * 100)}%"></span></span>
           <span class="t">${Math.round(t.progress * 100)}%</span>` : ""}
      ${["failed", "cancelled"].includes(t.status)
        ? `<button data-retry="${t.id}">Retry</button>` : ""}
      ${t.error ? `<div class="t">${esc(t.error.slice(0, 120))}</div>` : ""}
    </div>`).join("") || "<p>No tasks.</p>";
  for (const b of document.querySelectorAll("[data-retry]"))
    b.onclick = async (e) => { e.stopPropagation();
      await api(`/tasks/${b.dataset.retry}/retry`, { method: "POST" }); renderTasks(); };
}
function stopTaskUpdates() {
  clearInterval(state.tasksTimer); state.tasksTimer = null;
  if (state.tasksSource) { state.tasksSource.close(); state.tasksSource = null; }
}
function startTaskUpdates() {
  // called ONLY while the Tasks tab is visible (a stream per page view would
  // poll the server for nothing); SSE first, interval polling as the
  // fallback — including after any SSE error/stream end, so updates never
  // silently freeze
  stopTaskUpdates();
  const fallback = () => {
    stopTaskUpdates();
    state.tasksTimer = setInterval(() => {
      if (state.tab === "tasks") renderTasks(); else stopTaskUpdates();
    }, 5000);
  };
  if (window.EventSource) {
    try {
      const es = new EventSource(`${API}/tasks/stream?interval=2`);
      es.onmessage = () => { if (state.tab === "tasks") renderTasks();
                             else stopTaskUpdates(); };
      es.onerror = fallback;
      state.tasksSource = es;
      return;
    } catch (e) { /* fall through to polling */ }
  }
  fallback();
}

/* ---------- jump ----------
 * Aggregated options (reference JumpNavigationControl.tsx:23-140): kinds with
 * counts, per-label object options, per-cluster face options, a confidence
 * slider. One /jump-options request per opened video. */
const KIND_LABELS = { scene: "Scene", object: "Object", face: "Face",
  transcript: "Transcript", ocr: "OCR", place: "Place", speaker: "Speaker" };

async function loadJumpOptions() {
  /* Stale-response guard: opening video B while A's request is in flight
   * must not let A's late response rebuild B's dropdowns; and a video with
   * no artifacts (or a failed fetch) must RESET to the static kind list
   * instead of keeping the previous video's options. */
  const forVideo = state.video.id;
  if (!state.staticKindHtml) state.staticKindHtml = $("jump-kind").innerHTML;
  let opts = { kinds: [] };
  try {
    opts = await api(`/videos/${forVideo}/jump-options`);
  } catch (e) { /* falls through to the static kind list */ }
  if (state.video?.id !== forVideo) return; // a newer video took over
  state.jumpOptions = opts;
  const kinds = opts.kinds;
  $("jump-kind").innerHTML = kinds.length
    ? kinds.map(k =>
      `<option value="${k.kind}">${KIND_LABELS[k.kind] || k.kind} (${k.count})</option>`
    ).join("")
    : state.staticKindHtml;
  renderJumpTargets();
}

function renderJumpTargets() {
  const kind = $("jump-kind").value;
  const entry = (state.jumpOptions?.kinds || []).find(k => k.kind === kind);
  const sel = $("jump-target");
  const opts = entry?.labels
    ? entry.labels.map(l => ({ v: l.label, t: `${l.label} (${l.count})` }))
    : entry?.clusters
      ? entry.clusters.map(c => ({ v: c.cluster_id, t: `cluster ${c.cluster_id} (${c.count})` }))
      : entry?.speakers
        ? entry.speakers.map(s => ({ v: s.speaker, t: `${s.speaker} (${s.count})` }))
        : [];
  if (!opts.length) { sel.classList.add("hidden"); sel.innerHTML = ""; return; }
  sel.classList.remove("hidden");
  sel.innerHTML = `<option value="">any (${entry.count})</option>` +
    opts.map(o => `<option value="${esc(String(o.v))}">${esc(o.t)}</option>`).join("");
}

async function jump(direction) {
  const kind = $("jump-kind").value;
  const params = new URLSearchParams({ kind, direction,
    from_ms: String(Math.round($("video").currentTime * 1000)) });
  const target = $("jump-target").value;
  if (target) {
    const entry = (state.jumpOptions?.kinds || []).find(k => k.kind === kind);
    params.set(entry?.clusters ? "cluster_id" : "label", target);
  }
  const conf = +$("jump-conf").value;
  if (conf > 0) params.set("min_confidence", String(conf));
  const res = await api(`/videos/${state.video.id}/jump?${params}`);
  if (res.found) seek(res.jump_to.start_ms);
}

/* ---------- find ---------- */
async function findInVideo() {
  const q = $("find-input").value.trim();
  if (!q) return;
  const from = Math.round($("video").currentTime * 1000);
  const { matches } = await api(
    `/videos/${state.video.id}/find?q=${encodeURIComponent(q)}&from_ms=0`);
  // snippets are raw transcript/OCR text with FTS <b> markers: escape
  // everything, then re-enable just the markers (XSS: indexed content is
  // attacker-controllable via what a video says or shows on screen)
  const snip = (t) => esc(t).replaceAll("&lt;b&gt;", "<b>")
                            .replaceAll("&lt;/b&gt;", "</b>");
  $("find-results").innerHTML = matches.map(m => `
    <div class="seg" data-ms="${m.jump_to.start_ms}">
      <span class="t">${fmtMs(m.jump_to.start_ms)}</span>
      <span class="chip">${esc(m.source)}</span> ${snip(m.snippet)}
    </div>`).join("") || "<p>No matches.</p>";
  for (const el of $("find-results").querySelectorAll(".seg"))
    el.onclick = () => seek(+el.dataset.ms);
  const next = matches.find(m => m.jump_to.start_ms >= from);
  if (next) seek(next.jump_to.start_ms);
}

/* ---------- storyboard (scene strip under the player) ---------- */
async function loadStoryboard(id) {
  const box = $("storyboard");
  box.innerHTML = "";
  try {
    const { artifacts } = await api(`/videos/${id}/artifacts?type=scene`);
    let scenes = artifacts
      .map(a => ({ ms: Math.round((a.span_start_ms + a.span_end_ms) / 2),
                   start: a.span_start_ms, idx: a.payload_json.scene_index }))
      .sort((a, b) => a.start - b.start);
    if (!scenes.length) return;
    if (scenes.length > 24) {  // uniform thinning keeps temporal coverage
      const step = (scenes.length - 1) / 23;
      scenes = Array.from({ length: 24 },
                          (_, i) => scenes[Math.round(i * step)]);
    }
    box.innerHTML = scenes.map(s => `
      <img class="board-thumb" loading="lazy" alt="" data-ms="${s.start}"
        title="scene ${s.idx ?? "?"} · ${fmtMs(s.start)}"
        src="${API}/videos/${id}/thumbnail?at_ms=${s.ms}"
        onerror="this.style.display='none'">`).join("");
    for (const img of box.querySelectorAll(".board-thumb"))
      img.onclick = () => seek(+img.dataset.ms);
  } catch (e) { /* storyboard is best-effort */ }
}

/* ---------- similar moments (CLIP, cross-library) ---------- */
async function findSimilar() {
  const at = Math.round($("video").currentTime * 1000);
  const box = $("find-results");
  box.innerHTML = "<em>Finding similar moments…</em>";
  try {
    const { results } = await api(
      `/videos/${state.video.id}/similar?at_ms=${at}&top_k=8`);
    box.innerHTML = results.map(r => `
      <div class="seg" data-vid="${r.video_id}" data-ms="${r.ts_ms}">
        <img class="mini-thumb" loading="lazy" alt=""
          src="${API}/videos/${r.video_id}/thumbnail?at_ms=${r.ts_ms}"
          onerror="this.style.display='none'">
        <span class="t">${fmtMs(r.ts_ms)}</span>
        <span class="fname">${esc(state.videoPaths[r.video_id] || "")}</span>
        <span class="chip">${r.score.toFixed(3)}</span>
      </div>`).join("") || "<p>No indexed moments yet.</p>";
    for (const el of box.querySelectorAll(".seg"))
      el.onclick = () => {
        if (el.dataset.vid === state.video.id) seek(+el.dataset.ms);
        else openVideo(el.dataset.vid, +el.dataset.ms);
      };
  } catch (e) { box.innerHTML = `<p>Similar unavailable: ${esc(e.message)}</p>`; }
}

/* ---------- overlays ---------- */
function drawOverlays() {
  const video = $("video"), canvas = $("overlay");
  if (!state.video || video.videoWidth === 0) return;
  if (!state.overlays.objects && !state.overlays.faces && !state.overlays.ocr) {
    canvas.getContext("2d").clearRect(0, 0, canvas.width, canvas.height);
    return;
  }
  canvas.width = video.videoWidth; canvas.height = video.videoHeight;
  const ctx = canvas.getContext("2d");
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const nowMs = video.currentTime * 1000;
  const draw = (arts, color, getBox, getTag) => {
    for (const a of arts) {
      if (nowMs < a.span_start_ms - 250 || nowMs > a.span_end_ms + 250) continue;
      ctx.strokeStyle = color; ctx.fillStyle = color; ctx.lineWidth = 2;
      const box = getBox(a.payload_json);
      if (!box) continue;
      ctx.strokeRect(box.x, box.y, box.width, box.height);
      const tag = getTag(a.payload_json);
      if (tag) { ctx.font = "13px sans-serif"; ctx.fillText(tag, box.x + 2, box.y - 4); }
    }
  };
  const cached = (t) => state.artifacts[`${t}:`] || [];
  if (state.overlays.objects)
    draw(cached("object.detection"), "#4f8cff", p => p.bounding_box, p => p.label);
  if (state.overlays.faces)
    draw(cached("face.detection"), "#6ad18b", p => p.bounding_box, () => "face");
  if (state.overlays.ocr)
    draw(cached("ocr.text"), "#ffc86a", p => {
      const xs = p.polygon.map(q => q[0]), ys = p.polygon.map(q => q[1]);
      return { x: Math.min(...xs), y: Math.min(...ys),
        width: Math.max(...xs) - Math.min(...xs),
        height: Math.max(...ys) - Math.min(...ys) };
    }, p => p.text.slice(0, 20));
}
function overlayLoop() {
  // one persistent rAF loop per open video; drawOverlays itself is a pure
  // render (an early return must not kill the loop before metadata loads)
  drawOverlays();
  state.overlayRaf = requestAnimationFrame(overlayLoop);
}
async function toggleOverlay(name, type) {
  state.overlays[name] = $(`toggle-${name}`).checked;
  if (state.overlays[name]) await fetchArtifacts(type);
}

/* ---------- transcript sync highlight ---------- */
setInterval(() => {
  if (state.tab !== "transcript" || $("player-view").classList.contains("hidden")) return;
  const nowMs = $("video").currentTime * 1000;
  for (const el of document.querySelectorAll("#tab-content .seg")) {
    const start = +el.dataset.ms;
    const next = el.nextElementSibling ? +el.nextElementSibling.dataset.ms : Infinity;
    el.classList.toggle("current", nowMs >= start && nowMs < next);
  }
}, 500);

/* ---------- wiring ---------- */
window.addEventListener("DOMContentLoaded", () => {
  loadGallery();
  $("search-btn").onclick = doSearch;
  $("people-btn").onclick = togglePeople;
  $("clip-btn").onclick = () => {
    if (!state.video) return;
    const t = Math.round($("video").currentTime * 1000);
    const start = Math.max(0, t - 5000);
    // server remuxes (stream copy) and serves the cached file
    window.open(`${API}/videos/${state.video.id}/clip?start_ms=${start}` +
                `&end_ms=${t + 15000}`, "_blank");
  };
  $("search-input").onkeydown = (e) => { if (e.key === "Enter") doSearch(); };
  $("gallery-sort").onchange = loadGallery;
  let filterTimer = null;
  $("gallery-filter").oninput = () => {  // debounce server-side filtering
    clearTimeout(filterTimer); filterTimer = setTimeout(loadGallery, 250);
  };
  $("back-btn").onclick = () => closeVideo();
  window.onpopstate = () => {
    const m = location.hash.match(/#v=(.+)/);
    if (m) openVideo(m[1], null, true); else if (state.video) closeVideo(true);
  };
  for (const b of document.querySelectorAll("#tabs button"))
    b.onclick = () => selectTab(b.dataset.tab);
  $("run-selector").onchange = () => { state.run = $("run-selector").value; renderTab(); };
  $("jump-next").onclick = () => jump("next");
  $("jump-prev").onclick = () => jump("prev");
  $("jump-kind").onchange = renderJumpTargets;
  $("jump-conf").oninput = () => { $("jump-conf-val").textContent = $("jump-conf").value; };
  $("find-btn").onclick = findInVideo;
  $("similar-btn").onclick = findSimilar;
  $("upload-btn").onclick = () => $("upload-input").click();
  $("upload-input").onchange = async (e) => {
    const file = e.target.files[0];
    if (!file) return;
    const btn = $("upload-btn");
    btn.disabled = true;
    btn.textContent = "Uploading…";
    try {
      // raw streaming body: fetch sends the File without multipart framing
      const r = await fetch(`${API}/videos/upload?filename=${
        encodeURIComponent(file.name)}`, { method: "PUT", body: file });
      if (!r.ok) {
        const err = await r.json().catch(() => ({}));
        alert(`Upload failed: ${err.detail || r.status}`);
      }
      loadGallery();
    } finally {
      btn.disabled = false;
      btn.textContent = "Upload";
      e.target.value = "";
    }
  };
  $("find-input").onkeydown = (e) => { if (e.key === "Enter") findInVideo(); };
  $("toggle-objects").onchange = () => toggleOverlay("objects", "object.detection");
  $("toggle-faces").onchange = () => toggleOverlay("faces", "face.detection");
  $("toggle-ocr").onchange = () => toggleOverlay("ocr", "ocr.text");
  // global keyboard shortcuts (spec req 8.5) — discoverable via "?"
  window.addEventListener("keydown", (e) => {
    const tag = document.activeElement?.tagName;
    if (tag === "INPUT" || tag === "SELECT" || tag === "TEXTAREA") {
      if (e.key === "Escape") document.activeElement.blur();
      return;  // typing, not commanding
    }
    if (e.ctrlKey || e.metaKey || e.altKey) return;
    const video = $("video"), inPlayer = !!state.video;
    const acts = {
      "/": () => { e.preventDefault(); $("search-input").focus(); },
      "?": () => $("shortcut-help").classList.toggle("hidden"),
      "Escape": () => {  // layered: first Esc dismisses the overlay only
        if (!$("shortcut-help").classList.contains("hidden"))
          return $("shortcut-help").classList.add("hidden");
        if (inPlayer) closeVideo();
      },
      " ": () => { if (inPlayer) { e.preventDefault();
                    video.paused ? video.play() : video.pause(); } },
      "ArrowLeft": () => { if (inPlayer) { e.preventDefault();
                             video.currentTime -= 5; } },
      "ArrowRight": () => { if (inPlayer) { e.preventDefault();
                             video.currentTime += 5; } },
      "j": () => { if (inPlayer) jump("prev"); },
      "k": () => { if (inPlayer) jump("next"); },
      "f": () => { if (inPlayer) { e.preventDefault(); $("find-input").focus(); } },
    };
    acts[e.key]?.();
  });
  const m = location.hash.match(/#v=(.+)/);
  if (m) openVideo(m[1]);
});
