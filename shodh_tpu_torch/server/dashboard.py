"""Web dashboard (reference: ``front/`` — a vite/react SPA with chat,
recall, geo, graph, anomalies and tasks views over the JSON API).

Same surface here as ONE dependency-free, hash-routed single-page app
served at ``/dashboard``: recall (search + score attribution + remember +
reinforce), graph (canvas force layout + entity inspector), tasks
(projects/todos CRUD), anomalies (outlier scatter), activity (live SSE
tail). No build step, no JS dependencies — the reference's HashRouter
choice is kept (the page must work from any static mount).

Credentials: API key + user id live in localStorage (editable in the top
bar); every fetch sends X-API-Key/X-User-ID. The page itself is
unauthenticated (app.py public set) — all data stays key-gated.
"""

from __future__ import annotations

from shodh_tpu_torch.server import web

PAGE = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>shodh-tpu</title>
<style>
  :root { color-scheme: dark; }
  * { box-sizing: border-box; }
  body { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
         background: #0d1117; color: #c9d1d9; margin: 0; }
  a { color: inherit; text-decoration: none; }
  #top { display: flex; align-items: center; gap: 1rem; padding: 10px 16px;
         border-bottom: 1px solid #21262d; background: #161b22;
         position: sticky; top: 0; }
  #top h1 { font-size: 1rem; color: #58a6ff; margin: 0; }
  nav a { padding: 4px 10px; border-radius: 6px; color: #8b949e; }
  nav a.on { background: #1f2937; color: #58a6ff; }
  #creds input { width: 130px; background: #0d1117; color: #c9d1d9;
                 border: 1px solid #30363d; border-radius: 6px; padding: 4px 6px;
                 font: inherit; font-size: 0.78rem; }
  main { padding: 16px; }
  .grid { display: grid; grid-template-columns: 1fr 1fr; gap: 1rem; }
  .card { background: #161b22; border: 1px solid #21262d; border-radius: 8px;
          padding: 1rem; margin-bottom: 1rem; }
  .card h2 { font-size: 0.9rem; color: #8b949e; margin: 0 0 8px;
             border-bottom: 1px solid #21262d; padding-bottom: 4px; }
  input, textarea, select, button {
    background: #0d1117; color: #c9d1d9; border: 1px solid #30363d;
    border-radius: 6px; padding: 7px; font: inherit; font-size: 0.85rem; }
  input, textarea { width: 100%; }
  button { cursor: pointer; width: auto; }
  button:hover { border-color: #58a6ff; }
  ul { list-style: none; padding: 0; margin: 0.4rem 0; }
  li { padding: 5px 0; border-bottom: 1px dotted #21262d; font-size: 0.84rem; }
  .score { color: #3fb950; margin-right: 6px; }
  .kind  { color: #d29922; margin-right: 6px; }
  .dim   { color: #8b949e; }
  .warn  { color: #f85149; }
  .stat { display: inline-block; margin-right: 1.2rem; }
  .stat b { color: #58a6ff; font-size: 1.15rem; }
  .attr { font-size: 0.74rem; color: #8b949e; white-space: pre-wrap;
          background: #0d1117; border-radius: 6px; padding: 6px;
          margin-top: 4px; display: none; }
  li.open .attr { display: block; }
  canvas { width: 100%; background: #0b0e14; border-radius: 8px; }
  .row { display: flex; gap: 8px; align-items: center; }
  .row > * { flex-shrink: 0; }
  .row input { flex: 1 1 auto; }
  .pill { border: 1px solid #30363d; border-radius: 10px; padding: 1px 8px;
          font-size: 0.72rem; color: #8b949e; margin-left: 6px; }
  .mini { font-size: 0.74rem; padding: 2px 7px; margin-left: 4px; }
  #log li { font-size: 0.76rem; border: 0; padding: 2px 0; }
</style>
</head>
<body>
<div id="top">
  <h1>shodh-tpu</h1>
  <nav id="nav">
    <a href="#/recall">recall</a><a href="#/graph">graph</a>
    <a href="#/tasks">tasks</a><a href="#/anomalies">anomalies</a>
    <a href="#/activity">activity</a>
  </nav>
  <span style="flex:1"></span>
  <span id="creds">
    key <input id="key" placeholder="API key">
    user <input id="user" placeholder="default" style="width:90px">
  </span>
</div>
<main id="view"></main>
<script>
"use strict";
const $ = (id) => document.getElementById(id);
const store = window.localStorage;
$("key").value = store.getItem("shodh_key") || "";
$("user").value = store.getItem("shodh_user") || "default";
$("key").onchange = () => { store.setItem("shodh_key", $("key").value); route(); };
$("user").onchange = () => { store.setItem("shodh_user", $("user").value); route(); };
const H = () => ({"X-API-Key": $("key").value, "X-User-ID": $("user").value || "default",
                  "Content-Type": "application/json"});
const get = (p) => fetch(p, {headers: H()}).then(r => r.json());
const post = (p, b) => fetch(p, {method: "POST", headers: H(),
                                 body: JSON.stringify(b || {})}).then(r => r.json());
const esc = (s) => String(s ?? "").replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const memLine = (m, extra) =>
  `<li onclick="this.classList.toggle('open')">` +
  (m.score != null ? `<span class="score">${m.score.toFixed(3)}</span>` : "") +
  `<span class="kind">${esc(m.experience?.experience_type || m.experience_type || "")}</span>` +
  esc((m.experience?.content || m.content || "").slice(0, 160)) + (extra || "") +
  (m.attribution ? `<div class="attr">${esc(JSON.stringify(m.attribution, null, 1))}</div>` : "") +
  `</li>`;

// ---------------------------------------------------------------- recall --
async function viewRecall(el) {
  el.innerHTML = `
  <div class="card" id="stats">loading stats…</div>
  <div class="grid">
    <div class="card"><h2>semantic recall <span class="pill">debug attribution</span></h2>
      <input id="q" placeholder="query — press Enter"><ul id="results"></ul></div>
    <div class="card"><h2>remember</h2>
      <textarea id="newmem" rows="3" placeholder="new memory content"></textarea>
      <div class="row" style="margin-top:6px">
        <button onclick="addMem()">remember</button><span id="memstatus" class="dim"></span>
      </div>
      <h2 style="margin-top:12px">recent</h2><ul id="recent"></ul></div>
  </div>`;
  const s = await get("/api/stats").catch(() => null);
  $("stats").innerHTML = s && s.total_memories !== undefined ?
    `<span class="stat"><b>${s.total_memories}</b> memories</span>` +
    `<span class="stat"><b>${s.index_rows}</b> vectors</span>` +
    `<span class="stat"><b>${s.working_count}</b> working</span>` +
    (s.graph ? `<span class="stat"><b>${s.graph.entities}</b> entities</span>` +
               `<span class="stat"><b>${s.graph.edges}</b> edges</span>` +
               `<span class="stat"><b>${(s.graph.density ?? 0).toFixed(2)}</b> density</span>` : "")
    : `<span class="warn">stats unavailable — check the API key (top right)</span>`;
  $("q").onkeydown = async (e) => {
    if (e.key !== "Enter") return;
    const r = await post("/api/recall", {query: $("q").value, max_results: 10, debug: true});
    $("results").innerHTML = (r.memories || []).map(m => memLine(m)).join("") ||
      `<li class="dim">no results</li>`;
  };
  window.addMem = async () => {
    const content = $("newmem").value.trim();
    if (!content) return;
    const r = await post("/api/remember", {content});
    $("memstatus").textContent = r.memory_id ? `stored ${r.memory_id.slice(0,8)}` : JSON.stringify(r);
    $("newmem").value = "";
    loadRecent();
  };
  async function loadRecent() {
    const r = await get("/api/memories?limit=12").catch(() => ({memories: []}));
    $("recent").innerHTML = (r.memories || []).map(m => memLine(m)).join("");
  }
  loadRecent();
}

// ----------------------------------------------------------------- graph --
async function viewGraph(el) {
  el.innerHTML = `
  <div class="grid" style="grid-template-columns: 2fr 1fr">
    <div class="card"><h2>entity graph <span class="pill" id="gcount"></span></h2>
      <canvas id="gc" height="520"></canvas></div>
    <div class="card"><h2>inspector</h2><div id="ginfo" class="dim">click a node</div>
      <ul id="gneighbors"></ul></div>
  </div>`;
  const user = $("user").value || "default";
  const data = await get(`/api/graph/data/${user}`).catch(() => ({nodes: [], edges: []}));
  $("gcount").textContent = `${(data.nodes||[]).length} nodes · ${(data.edges||[]).length} edges`;
  const cv = $("gc"), ctx = cv.getContext("2d");
  cv.width = cv.clientWidth; const W = cv.width, Ht = cv.height;
  const pos = {};
  (data.nodes || []).forEach((n, i) => {
    const a = (i / Math.max(1, data.nodes.length)) * 2 * Math.PI;
    pos[n.id] = {x: W/2 + Math.cos(a)*Ht*0.4, y: Ht/2 + Math.sin(a)*Ht*0.4, n};
  });
  for (let it = 0; it < 80; it++)
    (data.edges || []).forEach(e => {
      const a = pos[e.source], b = pos[e.target]; if (!a || !b) return;
      const dx = b.x-a.x, dy = b.y-a.y, d = Math.hypot(dx,dy)||1, f = (d-80)/d*0.04;
      a.x+=dx*f; a.y+=dy*f; b.x-=dx*f; b.y-=dy*f;
    });
  function draw(sel) {
    ctx.clearRect(0, 0, W, Ht);
    ctx.strokeStyle = "#2a3142";
    (data.edges || []).forEach(e => {
      const a = pos[e.source], b = pos[e.target]; if (!a || !b) return;
      ctx.beginPath(); ctx.moveTo(a.x, a.y); ctx.lineTo(b.x, b.y); ctx.stroke();
    });
    Object.values(pos).forEach(p => {
      ctx.beginPath();
      ctx.fillStyle = p.n.id === sel ? "#f7768e" : ((p.n.strength||0) > .7 ? "#d29922" : "#7aa2f7");
      ctx.arc(p.x, p.y, (p.n.size||5)/1.4 + 2, 0, 7); ctx.fill();
      ctx.fillStyle = "#8a93a8"; ctx.font = "10px monospace";
      ctx.fillText(p.n.label, p.x + 7, p.y + 3);
    });
  }
  draw(null);
  cv.onclick = async (ev) => {
    const r = cv.getBoundingClientRect();
    const x = ev.clientX - r.left, y = ev.clientY - r.top;
    let best = null, bd = 1e9;
    Object.values(pos).forEach(p => {
      const d = Math.hypot(p.x - x, p.y - y);
      if (d < bd) { bd = d; best = p; }
    });
    if (!best || bd > 30) return;
    draw(best.n.id);
    $("ginfo").innerHTML = `<b>${esc(best.n.label)}</b>` +
      ` <span class="pill">${esc(best.n.tier)}</span>` +
      `<div class="dim">strength ${best.n.strength}</div>`;
    const tr = await post("/api/graph/traverse", {entity: best.n.label, hops: 2}).catch(() => null);
    $("gneighbors").innerHTML = ((tr && tr.results) || []).slice(0, 20).map(t =>
      `<li>${esc(t.entity)} <span class="dim">hop ${t.hop} · ${(t.strength ?? 0).toFixed?.(2) ?? t.strength}</span></li>`
    ).join("") || `<li class="dim">no connected entities</li>`;
  };
}

// ----------------------------------------------------------------- tasks --
async function viewTasks(el) {
  el.innerHTML = `
  <div class="grid">
    <div class="card"><h2>todos</h2>
      <div class="row"><input id="newtodo" placeholder="new todo — Enter">
        <select id="filter"><option value="">all</option><option>pending</option>
        <option>in_progress</option><option>blocked</option><option>done</option></select></div>
      <ul id="todos"></ul></div>
    <div class="card"><h2>projects</h2>
      <div class="row"><input id="newproj" placeholder="new project — Enter"></div>
      <ul id="projects"></ul>
      <h2 style="margin-top:10px">stats</h2><div id="tstats" class="dim"></div></div>
  </div>`;
  async function load() {
    const f = $("filter").value;
    const r = await get("/api/todos/list" + (f ? `?status=${f}` : "")).catch(() => ({todos: []}));
    $("todos").innerHTML = (r.todos || []).map(t =>
      `<li><span class="kind">${esc(t.status)}/${esc(t.priority)}</span> ${esc(t.title)}` +
      `<button class="mini" onclick="doneTodo('${t.id}')">✓</button>` +
      `<button class="mini" onclick="delTodo('${t.id}')">✗</button></li>`).join("") ||
      `<li class="dim">none</li>`;
    const p = await get("/api/projects/list").catch(() => ({projects: []}));
    $("projects").innerHTML = (p.projects || []).map(x =>
      `<li>${esc(x.name)} <span class="dim">${esc(x.status)}</span></li>`).join("") ||
      `<li class="dim">none</li>`;
    const s = await get("/api/todos/stats").catch(() => null);
    $("tstats").textContent = s ? JSON.stringify(s) : "";
  }
  window.doneTodo = async (id) => { await post("/api/todos/complete", {todo_id: id}); load(); };
  window.delTodo = async (id) => { await post("/api/todos/delete", {todo_id: id}); load(); };
  $("newtodo").onkeydown = async (e) => {
    if (e.key !== "Enter" || !$("newtodo").value.trim()) return;
    await post("/api/todos/add", {title: $("newtodo").value.trim()});
    $("newtodo").value = ""; load();
  };
  $("newproj").onkeydown = async (e) => {
    if (e.key !== "Enter" || !$("newproj").value.trim()) return;
    await post("/api/projects/add", {name: $("newproj").value.trim()});
    $("newproj").value = ""; load();
  };
  $("filter").onchange = load;
  load();
}

// ------------------------------------------------------------- anomalies --
async function viewAnomalies(el) {
  el.innerHTML = `
  <div class="card"><h2>anomalies <span class="pill" id="acount"></span></h2>
    <canvas id="ac" height="220"></canvas><ul id="alist"></ul></div>`;
  const r = await get("/api/anomalies").catch(() => ({anomalies: []}));
  const rows = r.anomalies || [];
  $("acount").textContent = `${rows.length} flagged`;
  $("alist").innerHTML = rows.map(a =>
    `<li><span class="warn">${esc(a.reason)}</span> ` +
    `${a.sim !== undefined ? `<span class="dim">sim ${(+a.sim).toFixed(3)}</span> ` : ""}` +
    esc(a.content || a.id) + `</li>`).join("") || `<li class="dim">none detected</li>`;
  const cv = $("ac"), ctx = cv.getContext("2d");
  cv.width = cv.clientWidth;
  const sims = rows.map(a => +a.sim).filter(x => !isNaN(x));
  if (sims.length) {  // centroid-similarity scatter: left = most anomalous
    const lo = Math.min(...sims), hi = Math.max(...sims), span = (hi - lo) || 1;
    ctx.fillStyle = "#8a93a8"; ctx.font = "10px monospace";
    ctx.fillText(`centroid similarity  ${lo.toFixed(2)} … ${hi.toFixed(2)}`, 8, 12);
    sims.forEach((s, i) => {
      ctx.beginPath(); ctx.fillStyle = "#f7768e";
      ctx.arc(20 + (s - lo) / span * (cv.width - 40),
              40 + (i % 12) * 14, 4, 0, 7);
      ctx.fill();
    });
  } else {
    ctx.fillStyle = "#8a93a8"; ctx.font = "12px monospace";
    ctx.fillText("no statistical outliers (needs >= 8 embedded memories)", 10, 30);
  }
}

// -------------------------------------------------------------- activity --
let evtSource = null;
async function viewActivity(el) {
  el.innerHTML = `
  <div class="card"><h2>live events <span class="pill">SSE /api/events/sse</span></h2>
    <ul id="log"><li class="dim">listening…</li></ul></div>
  <div class="card"><h2>consolidation report</h2><div id="report" class="dim"></div></div>`;
  const rep = await get("/api/consolidation/report").catch(() => null);
  $("report").textContent = rep ? JSON.stringify(rep) : "unavailable";
  // EventSource can't set headers; the SSE route accepts ?key= for this page
  const key = encodeURIComponent($("key").value);
  const user = encodeURIComponent($("user").value || "default");
  if (evtSource) evtSource.close();
  evtSource = new EventSource(`/api/events/sse?key=${key}&user=${user}`);
  evtSource.onmessage = (ev) => {
    const li = document.createElement("li");
    li.textContent = ev.data.slice(0, 220);
    $("log").prepend(li);
    while ($("log").children.length > 40) $("log").lastChild.remove();
  };
}

// --------------------------------------------------------------- routing --
const VIEWS = {recall: viewRecall, graph: viewGraph, tasks: viewTasks,
               anomalies: viewAnomalies, activity: viewActivity};
function route() {
  const name = (location.hash.replace("#/", "") || "recall");
  if (evtSource && name !== "activity") { evtSource.close(); evtSource = null; }
  document.querySelectorAll("#nav a").forEach(a =>
    a.classList.toggle("on", a.getAttribute("href") === `#/${name}`));
  (VIEWS[name] || viewRecall)($("view"));
}
window.addEventListener("hashchange", route);
route();
</script>
</body>
</html>
"""


GRAPH_VIEW_HTML = """<!doctype html>
<html>
<head><meta charset="utf-8"><title>shodh graph</title>
<style>
body { margin: 0; background: #0b0e14; color: #cdd6f4; font: 13px monospace; }
#bar { padding: 8px 12px; } input { background: #161b26; color: inherit;
border: 1px solid #2a3142; padding: 4px 8px; width: 280px; }
svg { width: 100vw; height: calc(100vh - 40px); }
circle { fill: #7aa2f7; } circle.hub { fill: #f7768e; }
line { stroke: #2a3142; stroke-width: 1; } text { fill: #8a93a8; font-size: 10px; }
</style></head>
<body>
<div id="bar">entity graph — <input id="key" placeholder="API key"/>
<input id="user" value="default" style="width:120px"/>
<button onclick="load()">load</button></div>
<svg id="g"></svg>
<script>
// Minimal dependency-free force layout over /api/graph/data/{user}
async function load() {
  const key = document.getElementById("key").value || new URLSearchParams(location.search).get("key") || "";
  const user = document.getElementById("user").value || "default";
  const r = await fetch(`/api/graph/data/${user}`, {headers: {"X-API-Key": key}});
  const data = await r.json();
  const svg = document.getElementById("g"); svg.innerHTML = "";
  const W = svg.clientWidth, H = svg.clientHeight;
  const pos = {};
  data.nodes.forEach((n, i) => {
    const a = (i / Math.max(1, data.nodes.length)) * 2 * Math.PI;
    pos[n.id] = [W/2 + Math.cos(a) * H * 0.38, H/2 + Math.sin(a) * H * 0.38, n];
  });
  // 60 rounds of spring relaxation
  for (let it = 0; it < 60; it++) {
    data.edges.forEach(e => {
      const a = pos[e.source], b = pos[e.target]; if (!a || !b) return;
      const dx = b[0]-a[0], dy = b[1]-a[1], d = Math.hypot(dx,dy)||1, f = (d-90)/d*0.05;
      a[0]+=dx*f; a[1]+=dy*f; b[0]-=dx*f; b[1]-=dy*f;
    });
  }
  data.edges.forEach(e => {
    const a = pos[e.source], b = pos[e.target]; if (!a || !b) return;
    const l = document.createElementNS("http://www.w3.org/2000/svg","line");
    l.setAttribute("x1",a[0]); l.setAttribute("y1",a[1]);
    l.setAttribute("x2",b[0]); l.setAttribute("y2",b[1]); svg.appendChild(l);
  });
  Object.values(pos).forEach(([x,y,n]) => {
    const c = document.createElementNS("http://www.w3.org/2000/svg","circle");
    c.setAttribute("cx",x); c.setAttribute("cy",y); c.setAttribute("r",n.size||5);
    if ((n.strength||0) > 0.7) c.setAttribute("class","hub");
    svg.appendChild(c);
    const t = document.createElementNS("http://www.w3.org/2000/svg","text");
    t.setAttribute("x",x+8); t.setAttribute("y",y+3); t.textContent = n.label;
    svg.appendChild(t);
  });
}
</script>
</body>
</html>
"""


def register_dashboard(app) -> None:
    async def dashboard(request: web.Request):
        return web.Response(text=PAGE, content_type="text/html")

    app.router.add_get("/dashboard", dashboard)
    app.router.add_get("/", dashboard)
