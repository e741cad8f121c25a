"""Tuning service: multi-client search sessions over TCP + HTTP monitor.

A copy of ``offt_tpu/tune/service.py`` (the same wire protocol, so the
reference's clients, the port's and the native server interoperate).

Re-expression of Active Harmony's ``hserver`` (
activeharmony/build/hserver.c): a server owning search *sessions* that
remote clients join, fetch candidate points from, and report performance
to — with a live monitoring UI served from the same TCP port by protocol
sniffing (hserver classifies connections by peeking for HMESG_MAGIC,
hserver.c:413-460; we peek for an HTTP method token).

Differences by design: the wire protocol is JSON-lines instead of the
magic+length text format (hmesg.c), sessions run strategies in-process
threads instead of fork/exec'd session-core children, and the monitor
renders an inline SVG chart instead of flot.js. Semantics preserved:
- session create with a declared space (name:values dims), strategy choice
- fetch -> point, report(point, perf), best, converged  (hclient.h API)
- per-session trial history with timestamps for the UI (hserver.c:520-555)

Run:  python -m offt_tpu_torch.tune.service --port 1979
Client: offt_tpu_torch.tune.client.ServiceClient (or the offt-tune CLI with
--server host:port).
"""

from __future__ import annotations

import argparse
import html
import json
import socket
import socketserver
import threading
import time
from typing import Optional

from ..plan.params import ProblemSpec
from .space import Dimension
from .strategies import make_strategy
from .synth import _SynthSpace

DEFAULT_PORT = 1979  # the reference's default (defaults.h:24)


class Session:
    def __init__(self, sid: int, name: str, dims, strategy: str, seed: int,
                 cfg: Optional[dict] = None):
        self.sid = sid
        self.name = name
        space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)),
                            dims=tuple(Dimension(n, tuple(v)) for n, v in dims))
        self.space = space
        self.strategy = make_strategy(strategy, space, seed=seed)
        self.lock = threading.Lock()
        self.history: list[tuple[float, list, float]] = []
        self.outstanding: set = set()
        # runtime config database (harmony_query/harmony_inform,
        # hclient.h:95-128 / session_query/session_inform
        # session-core.c:927-935): string key/value pairs living only in
        # memory, seeded from the session descriptor. Two keys are live:
        # STRATEGY_CONVERGED reflects the strategy (defaults.h:39), and a
        # truthy PAUSED makes fetch return BUSY (clients then reuse best,
        # the hclient BUSY convention).
        self.cfg: dict[str, str] = {
            "SESSION_STRATEGY": str(strategy),
            "RANDOM_SEED": str(seed),
        }
        if cfg:
            self.cfg.update({str(k): str(v) for k, v in cfg.items()})

    def fetch(self) -> tuple[Optional[tuple], str]:
        """Returns (point, reason). point=None with reason "paused"
        (operator set PAUSED — temporary, clients should retry),
        "waiting" (the strategy is blocked on outstanding reports from
        OTHER clients — e.g. a PRO round fully issued but not yet fully
        reported; temporary, retry), or "exhausted" (the strategy has no
        more fresh points — final). The waiting/exhausted distinction is
        what lets N clients share one session without a mid-round fetch
        being misread as the end of the search (harmony_join multi-client
        flow, hclient.c:156-233)."""
        with self.lock:
            if self.cfg.get("PAUSED") not in (None, "", "0"):
                return None, "paused"
            pt = self.strategy.generate()
            if pt is None:
                if self.outstanding and not self.strategy.converged():
                    return None, "waiting"
                return None, "exhausted"
            self.outstanding.add(tuple(pt))
            return pt, ""

    def getcfg(self, key: str) -> Optional[str]:
        with self.lock:
            if key == "STRATEGY_CONVERGED":
                return "1" if self.strategy.converged() else "0"
            return self.cfg.get(key)

    def setcfg(self, key: str, val) -> Optional[str]:
        """Set (or, with val=None, erase) a config key; returns the
        original value — harmony_inform's contract (hclient.h:106-128)."""
        with self.lock:
            old = self.cfg.get(key)
            if val is None:
                self.cfg.pop(key, None)
            else:
                self.cfg[key] = str(val)
            return old

    def report(self, point, perf: float):
        with self.lock:
            pt = tuple(point)
            fresh = pt in self.outstanding
            self.outstanding.discard(pt)
            # Only the FIRST report for an issued point drives the
            # strategy: when NM hands its current test point to two
            # clients, the second (stale) report would be misread as the
            # answer to whatever trial the first one triggered (or crash
            # on an empty pending slot). AH absorbs extra results into
            # the point DB only (session-core report flow) — we keep
            # them in history so best() still sees every measurement.
            if fresh:
                self.strategy.analyze(pt, float(perf))
            self.history.append((time.time(), list(point), float(perf)))
            if len(self.history) > 10000:   # bound UI history
                del self.history[:5000]

    def reject(self, point):
        with self.lock:
            pt = tuple(point)
            fresh = pt in self.outstanding
            self.outstanding.discard(pt)
            if fresh:
                self.strategy.rejected(pt)

    def best(self):
        with self.lock:
            pt = self.strategy.best()
            if pt is None:
                return None, None
            vals = self.space.to_params(pt)
            perfs = [p for _, q, p in self.history if tuple(q) == tuple(pt)]
            return list(vals), (min(perfs) if perfs else None)

    def converged(self) -> bool:
        with self.lock:
            return self.strategy.converged()


class TuningServer:
    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.sessions: dict[int, Session] = {}
        self._next_sid = 1
        self._lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._handle_conn(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((host, port), Handler)
        self.host, self.port = self._srv.server_address

    # ---- connection sniffing (hserver.c handle_unknown_connection) ------
    def _handle_conn(self, sock: socket.socket):
        # a silent client must not pin a handler thread forever on the peek
        sock.settimeout(30.0)
        try:
            head = sock.recv(8, socket.MSG_PEEK)
        except (socket.timeout, OSError):
            return
        if head[:4] in (b"GET ", b"HEAD", b"POST"):
            self._handle_http(sock)
        else:
            sock.settimeout(None)  # tuning clients may think between ops
            self._handle_client(sock)

    # ---- JSON-lines tuning protocol ------------------------------------
    def _handle_client(self, sock: socket.socket):
        fh = sock.makefile("rwb")
        try:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                    reply = self._dispatch(msg)
                except Exception as e:
                    reply = {"status": "FAIL", "error": repr(e)}
                fh.write((json.dumps(reply) + "\n").encode())
                fh.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "session":
            with self._lock:
                sid = self._next_sid
                self._next_sid += 1
                self.sessions[sid] = Session(
                    sid, msg.get("name", f"session-{sid}"),
                    [(d["name"], d["values"]) for d in msg["dims"]],
                    msg.get("strategy", "nm"), int(msg.get("seed", 0)),
                    cfg=msg.get("cfg"))
            return {"status": "OK", "session": sid}
        sid = int(msg.get("session", 0))
        sess = self.sessions.get(sid)
        if sess is None:
            return {"status": "FAIL", "error": f"no session {sid}"}
        if op == "fetch":
            pt, reason = sess.fetch()
            if pt is None:
                # hclient BUSY convention -> reuse best; "reason" lets the
                # client distinguish a temporary operator pause (retry)
                # from strategy exhaustion (stop)
                return {"status": "BUSY", "reason": reason}
            return {"status": "OK", "point": list(pt),
                    "values": list(sess.space.to_params(pt))}
        if op == "report":
            sess.report(msg["point"], msg["perf"])
            return {"status": "OK"}
        if op == "reject":
            sess.reject(msg["point"])
            return {"status": "OK"}
        if op == "best":
            vals, perf = sess.best()
            return {"status": "OK", "values": vals, "perf": perf}
        if op == "converged":
            return {"status": "OK", "converged": sess.converged()}
        if op == "getcfg":
            key = str(msg["key"])
            return {"status": "OK", "key": key, "value": sess.getcfg(key)}
        if op == "setcfg":
            key = str(msg["key"])
            old = sess.setcfg(key, msg.get("value"))
            return {"status": "OK", "key": key, "old": old}
        if op == "leave":
            return {"status": "OK"}
        return {"status": "FAIL", "error": f"unknown op {op!r}"}

    # ---- HTTP monitor (httpsvr.c + overview.cgi/session-view.cgi) -------
    def _handle_http(self, sock: socket.socket):
        try:
            data = sock.recv(4096).decode("latin-1")
        except (socket.timeout, OSError):
            return
        parts = data.split(" ")
        path = parts[1] if len(parts) > 1 else "/"
        if path.startswith("/session/"):
            try:
                body = self._session_page(int(path.split("/")[2]))
            except (ValueError, KeyError):
                body, status = "not found", "404 Not Found"
                self._http_reply(sock, body, status)
                return
        elif path.startswith("/api/session/"):
            # incremental trial stream (the live-update analogue of
            # hserver's refresh loop, httpsvr.c:62-77 + hserver.c:520-555):
            # /api/session/<id>?since=N returns trials[N:] so the page can
            # poll without re-rendering history
            try:
                tail = path[len("/api/session/"):]
                sid_s, _, query = tail.partition("?")
                since = 0
                for kv in query.split("&"):
                    k, _, v = kv.partition("=")
                    if k == "since":
                        since = max(0, int(v))
                body = self._session_json(int(sid_s), since)
            except (ValueError, KeyError):
                self._http_reply(sock, "not found", "404 Not Found")
                return
            self._http_reply(sock, body, ctype="application/json")
            return
        elif path.startswith("/api/sessions"):
            body = json.dumps([
                {"id": s.sid, "name": s.name, "trials": len(s.history),
                 "converged": s.converged()}
                for s in self.sessions.values()])
            self._http_reply(sock, body, ctype="application/json")
            return
        else:
            body = self._overview_page()
        self._http_reply(sock, body)

    @staticmethod
    def _http_reply(sock, body: str, status="200 OK", ctype="text/html"):
        payload = body.encode()
        hdr = (f"HTTP/1.0 {status}\r\nContent-Type: {ctype}\r\n"
               f"Content-Length: {len(payload)}\r\n\r\n")
        try:
            sock.sendall(hdr.encode() + payload)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _overview_page(self) -> str:
        rows = "".join(
            f"<tr><td><a href='/session/{s.sid}'>{html.escape(s.name)}</a>"
            f"</td><td>{len(s.history)}</td><td>{s.converged()}</td></tr>"
            for s in self.sessions.values())
        return ("<html><head><title>offt-tpu tuning</title></head><body>"
                "<h2>offt-tpu tuning sessions</h2>"
                "<table border=1><tr><th>session</th><th>trials</th>"
                f"<th>converged</th></tr>{rows}</table></body></html>")

    def _session_json(self, sid: int, since: int = 0) -> str:
        s = self.sessions[sid]
        with s.lock:
            hist = list(s.history)
            cfg = dict(s.cfg)  # copy under the lock: setcfg mutates it
        best_vals, best_perf = s.best()
        if best_perf == float("inf"):
            best_perf = None
        return json.dumps({
            "id": s.sid, "name": s.name, "total": len(hist),
            "converged": s.converged(),
            "cfg": cfg,             # runtime config (session-view parity)
            "best": {"point": best_vals, "perf": best_perf},
            "trials": [[t, list(q), (None if p != p or p == float("inf")
                                     else p)]
                       for t, q, p in hist[since:]],
        })

    def _session_page(self, sid: int) -> str:
        s = self.sessions[sid]
        hist = list(s.history)
        pts = ""
        if hist:
            t0 = hist[0][0]
            perfs = [p for _, _, p in hist if p == p and p != float("inf")]
            if perfs:
                lo, hi = min(perfs), max(perfs)
                span = (hi - lo) or 1.0
                pts = " ".join(
                    f"{(t - t0) / max(hist[-1][0] - t0, 1e-9) * 560 + 20:.1f},"
                    f"{180 - (p - lo) / span * 160:.1f}"
                    for t, _, p in hist if p == p and p != float("inf"))
        # client-supplied points/values are untrusted: escape everything
        # interpolated into markup (the JSON protocol accepts arbitrary
        # values for "point")
        rows = "".join(
            f"<tr><td>{time.strftime('%H:%M:%S', time.localtime(t))}</td>"
            f"<td>{html.escape(repr(q))}</td><td>{p:.6g}</td></tr>"
            for t, q, p in hist[-200:])
        best_vals, best_perf = s.best()
        # live updates: poll /api/session/<id>?since=N and append — the
        # reference streams the same data into flot charts on a refresh
        # loop (httpsvr.c:62-77); textContent-only DOM writes keep
        # client-supplied values inert
        script = """
<script>
var SID=%d, seen=%d, data=[];
function redraw(){
  var perfs=data.filter(function(p){return p!=null;});
  if(!perfs.length) return;
  var lo=Math.min.apply(null,perfs), hi=Math.max.apply(null,perfs);
  var span=(hi-lo)||1, n=data.length, pts=[];
  for(var i=0;i<n;i++){ if(data[i]==null) continue;
    pts.push((i/(Math.max(n-1,1))*560+20).toFixed(1)+','+
             (180-(data[i]-lo)/span*160).toFixed(1)); }
  document.getElementById('chart').setAttribute('points', pts.join(' '));
}
function tick(){
  fetch('/api/session/'+SID+'?since='+seen).then(function(r){return r.json();})
  .then(function(j){
    if(j.trials.length){
      var tb=document.getElementById('hist');
      j.trials.forEach(function(tr){
        var row=document.createElement('tr');
        [new Date(tr[0]*1000).toLocaleTimeString(),
         JSON.stringify(tr[1]), tr[2]==null?'inf':tr[2].toPrecision(6)]
        .forEach(function(v){var td=document.createElement('td');
                 td.textContent=v; row.appendChild(td);});
        tb.appendChild(row);
        data.push(tr[2]);
      });
      seen=j.total;
      if(j.best && j.best.perf!=null)
        document.getElementById('best').textContent=
          'best: '+JSON.stringify(j.best.point)+' perf='+j.best.perf;
      redraw();
    }
    if(!j.converged) setTimeout(tick, 1000);
  }).catch(function(){ setTimeout(tick, 3000); });
}
setTimeout(tick, 1000);
</script>"""
        return (f"<html><body><h2>{html.escape(s.name)}</h2>"
                f"<p id='best'>best: {html.escape(repr(best_vals))} "
                f"perf={html.escape(repr(best_perf))}</p>"
                f"<svg width=600 height=200 style='border:1px solid #ccc'>"
                f"<polyline id='chart' fill='none' stroke='#36c' "
                f"points='{pts}'/></svg>"
                f"<table border=1><tr><th>time</th><th>point</th>"
                f"<th>perf</th></tr><tbody id='hist'>{rows}</tbody></table>"
                + script % (sid, len(hist)) + "</body></html>")

    # ---- lifecycle -------------------------------------------------------
    def serve_forever(self):
        self._srv.serve_forever()

    def start_background(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


def main(argv=None):
    from ..utils import config as _cfg

    p = argparse.ArgumentParser(prog="offt-torch-tune-server")
    p.add_argument("--host", default=_cfg.get("server_host"))
    p.add_argument("--port", type=int, default=int(_cfg.get("server_port")))
    ns = p.parse_args(argv)
    srv = TuningServer(ns.host, ns.port)
    print(f"offt-tpu tuning server on {srv.host}:{srv.port} "
          f"(HTTP monitor on the same port)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
