"""The UI's clients: closed loops of POSTs to the server, in one process
of their own.

Started by the `http` entry with this file's path; imports nothing but the
standard library, so that it shares no interpreter lock with the server
and never touches the card.  Each client is a thread with its own
connection, which sends its next request when the last reply is in.
Protocol on its pipes:

* stdin: one JSON line (host, port, route, each upload's byte count, the
  filters' request fields, each client's plan of (upload, filter) pairs
  and sample seed, the sample size), then the uploads' data-URL bytes;
* stdout: "ready" once the bodies are built and every client connected;
* stdin: one line "t0 t1" (`time.perf_counter` values, which the parent
  shares on Linux), after which each client sends request after request
  from t0 while the clock reads below t1;
* stdout: one JSON line (each request's send and last-byte times, status,
  client and plan index; each kept answer's client, plan index and byte
  count), then the kept answers' bytes: a seeded reservoir sample of each
  client's replies.
"""

from __future__ import annotations

import http.client
import json
import random
import sys
import threading
import time


def _body(upload: bytes, fields: dict) -> bytes:
    head = json.dumps(fields)[:-1].encode()   # '{"filter": ...' without '}'
    return head + b', "image": "' + upload + b'"}'


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
            u, f = self.plan[i % len(self.plan)]
            sent = time.perf_counter()
            try:
                self.conn.request("POST", hdr["route"], self.bodies[(u, f)],
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
    bodies = {(u, f): _body(up, hdr["fields"][f])
              for u, up in enumerate(uploads) for f in hdr["fields"]}
    clients = [Client(hdr, bodies, n) for n in range(len(hdr["plans"]))]
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
        "kept": [[n, i, len(d)] for n, i, d in kept]}).encode() + b"\n")
    for _, _, d in kept:
        stdout.write(d)
    stdout.flush()


if __name__ == "__main__":
    main()
