// Shared helpers for every crispy window (index / tray / result): the
// command-invoke shim, HTML escaping, duration formatting, the speaker
// palette, and the diarized-transcript grammar. ONE copy — the grammar
// below must stay in sync with engine/diarization.format_diarized_text
// (reference: src/components/TranscriptionResultView.tsx:55-120), and
// keeping it here means a format change cannot silently desync windows.
const $ = (s) => document.querySelector(s);
const api = async (name, args) => {
  const r = await fetch(`/api/${name}`, {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify(args || {})});
  const j = await r.json();
  if (!r.ok) throw new Error(j.error || r.statusText);
  return j;
};
// every dynamic string rendered into markup goes through esc()
const esc = (s) => String(s).replace(/[&<>"']/g, (c) =>
  ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
const fmtMB = (b) => (b/1048576).toFixed(b >= 104857600 ? 0 : 1) + " MB";
const fmtDur = (s) => `${Math.floor(s/60)}:${String(Math.round(s%60)).padStart(2,"0")}`;
const SPEAKERS = ["--s1","--s2","--s3","--s4","--s5","--s6","--s7","--s8"];

// [Speaker N|t] parser — the diarized transcript grammar
function parseSegments(text) {
  const segs = []; let who = null, t = null, block = [];
  const flush = () => { const s = block.join(" ").trim();
    if (s) segs.push({who, t, text: s}); block = []; };
  for (const line of text.split("\n")) {
    const m = line.match(/^\[(Speaker \d+)(?:\|([\d.]+))?\]\s*$/);
    if (m) { flush(); who = m[1]; t = m[2] ? parseFloat(m[2]) : null; }
    else if (line.trim()) block.push(line.trim());
  }
  flush(); return segs;
}
