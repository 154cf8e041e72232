"""The UI's clients: closed loops of POSTs to the server, in one process
of their own.

Started by the `http` entry with this file's path; imports nothing but the
standard library, so that it shares no interpreter lock with the server
and never touches the card.  Each client is a thread with its own
connection, which sends its next request when the last reply is in.
Protocol on its pipes:

* stdin: one JSON line (host, port, route, each upload's byte count, each
  call template's request fields, each client's plan of (upload,
  template) pairs and sample seed, the sample size), then the uploads'
  data-URL bytes;
* stdout: "ready" once the bodies are built and every client connected;
* stdin: one line "t0 t1" (`time.perf_counter` values, which the parent
  shares on Linux), after which each client sends request after request
  from t0 while the clock reads below t1;
* stdout: one JSON line (each request's send and last-byte times, status,
  client and plan index; each kept answer's client, plan index and byte
  count; this process's peak resident set where the host keeps one
  (VmHWM), else the larger of its resident sets when the bodies are built
  and at the end), then the kept answers' bytes: a seeded reservoir
  sample of each client's replies.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import sys
import threading
import time


def _body(upload: bytes, fields: dict) -> bytes:
    head = json.dumps(fields)[:-1].encode()   # '{"filter": ...' without '}'
    return head + b', "image": "' + upload + b'"}'


def _resident_kib() -> list[int]:
    """This process's resident set, KiB, as far as the host shows it: its
    peak since the exec (VmHWM) and now (VmRSS, statm's resident pages).
    Some hosts keep no VmHWM."""
    out = []
    try:
        with open("/proc/self/status") as f:
            out += [int(line.split()[1]) for line in f
                    if line.startswith(("VmHWM:", "VmRSS:"))]
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/self/statm") as f:
            out.append(int(f.read().split()[1])
                       * os.sysconf("SC_PAGE_SIZE") // 1024)
    except (OSError, ValueError, IndexError):
        pass
    return out


class Client:
    def __init__(self, hdr: dict, bodies: dict, n: int):
        self.hdr, self.bodies, self.n = hdr, bodies, n
        self.plan = [tuple(p) for p in hdr["plans"][n]]
        self.rnd = random.Random(hdr["sample_seeds"][n])
        self.records: list = []
        self.kept: list[tuple[int, bytes]] = []
        self.conn = self._connect()

    def _connect(self) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(self.hdr["host"], self.hdr["port"],
                                          timeout=600)
        conn.connect()
        return conn

    def loop(self, t0: float, t1: float) -> None:
        hdr, k = self.hdr, self.hdr["sample"]
        headers = {"Content-Type": "application/json"}
        while time.perf_counter() < t0:
            time.sleep(min(0.01, max(t0 - time.perf_counter(), 0)))
        i = 0
        while time.perf_counter() < t1:
            u, t = self.plan[i % len(self.plan)]
            sent = time.perf_counter()
            try:
                self.conn.request("POST", hdr["route"], self.bodies[(u, t)],
                                  headers)
                resp = self.conn.getresponse()
                data, status = resp.read(), resp.status
            except (OSError, http.client.HTTPException):
                data, status = b"", 0
                self.conn.close()
                self.conn = self._connect()
            self.records.append([sent, time.perf_counter(), status, self.n, i])
            # Reservoir sampling: each reply is kept with equal chance.
            if len(self.kept) < k:
                self.kept.append((i, data))
            else:
                j = self.rnd.randrange(i + 1)
                if j < k:
                    self.kept[j] = (i, data)
            i += 1
        self.conn.close()


def main() -> None:
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    hdr = json.loads(stdin.readline())
    uploads = [stdin.read(n) for n in hdr["upload_bytes"]]
    bodies = {(u, t): _body(up, fields)
              for u, up in enumerate(uploads)
              for t, fields in enumerate(hdr["fields"])}
    clients = [Client(hdr, bodies, n) for n in range(len(hdr["plans"]))]
    resident = _resident_kib()
    stdout.write(b"ready\n")
    stdout.flush()
    t0, t1 = map(float, stdin.readline().split())
    threads = [threading.Thread(target=c.loop, args=(t0, t1))
               for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    kept = [(c.n, i, d) for c in clients for i, d in c.kept]
    stdout.write(json.dumps({
        "records": [r for c in clients for r in c.records],
        "kept": [[n, i, len(d)] for n, i, d in kept],
        "peak_rss_kib": max(resident + _resident_kib(), default=None),
    }).encode() + b"\n")
    for _, _, d in kept:
        stdout.write(d)
    stdout.flush()


if __name__ == "__main__":
    main()
