"""The program's entry points that a mix drives, each a class with one
face: set up (start the program, make the inputs, warm the mix's shapes),
measure a window, hand back the window's calls and a seeded sample of its
answers, free the program, and hold the sample against the reference.

* `http`: the port's REST server, started in this process as
  `server/app.py::main` starts it, driven over a local port by clients,
  threads of a process of their own (`client.py`);
* `api`: the `gpu_filters`-shaped functions of `api/filters.py`, called
  here on host images;
* `forward`: the `nn.Module`s of `models/filters.py` on frames already on
  the card, one (H, W, C) frame a call, each call ending in a
  synchronize.

`alter(kind, fn)` replaces the program's function underneath (the
control and the planted faults of `tests/`); a run leaves it None.
"""

from __future__ import annotations

import base64
import gc
import json
import subprocess
import sys
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..inputs.scene import pool as image_pool
from ..reference import filters as reference
from ..reference import jpeg, png
from . import schedule
from .check import Comparison

CLIENT = Path(__file__).with_name("client.py")
ROUTE_STATS = "/api/stats"


@dataclass
class Context:
    config: dict
    mix: dict
    seed: int
    device: torch.device
    alter: Callable | None = None
    log: Callable[[str], None] = print


@dataclass
class Window:
    """A window's calls: (sent, done, ok) each, the calls' work
    descriptors, and what the run prints about them."""

    calls: list[tuple[float, float, bool]] = field(default_factory=list)
    work: list[schedule.Call] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)


class Reservoir:
    """A uniform seeded sample of `k` items of a stream."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _free_card() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class _Loop:
    """The in-process entries: one caller in a closed loop."""

    kind = ""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.rng = np.random.default_rng(ctx.seed)
        self.sample = Reservoir(int(ctx.mix["sample"]),
                                np.random.default_rng([ctx.seed, 1]))

    def _call(self, call: schedule.Call):
        raise NotImplementedError

    def _warm(self) -> None:
        for call in schedule.distinct_work(self.ctx.mix, self.ctx.config):
            for _ in range(int(self.ctx.mix.get("warm_repeats", 3))):
                self._call(call)

    def window(self, t0: float, t1: float) -> Window:
        win = Window()
        calls = schedule.calls(self.ctx.mix, self.ctx.config,
                               np.random.default_rng([self.ctx.seed, 2]))
        while time.perf_counter() < t0:
            pass
        while time.perf_counter() < t1:
            call = next(calls)
            sent = time.perf_counter()
            out = self._call(call)
            done = time.perf_counter()
            win.calls.append((sent, done, True))
            win.work.append(call)
            self.sample.offer((call, out))
        return win

    def collect(self, win: Window) -> Window:
        return win


class ApiEntry(_Loop):
    kind = "api"

    def setup(self) -> None:
        from gpu_image_processing_tpu_torch.api import filters as api

        self.api = api
        self.runtime = api.set_device(self.ctx.device)
        self.fn = self._program
        if self.ctx.alter is not None:
            self.fn = self.ctx.alter(self.kind, self.fn)
        cfg = self.ctx.config["scene"]
        self.images = image_pool(self.rng, (cfg["height"], cfg["width"]),
                                 [tuple(s) for s in self.ctx.mix["sizes"]],
                                 int(self.ctx.mix.get("pool", 1)))
        self._warm()

    def _program(self, call: schedule.Call, image: np.ndarray) -> np.ndarray:
        api, rt = self.api, self.runtime
        if call.filter == "gaussian":
            return api.gaussian_blur(image, sigma=call.sigma,
                                     radius=call.radius, level=call.level,
                                     runtime=rt)["image"]
        if call.filter == "box":
            return api.box_blur(image, radius=call.radius, level=call.level,
                                runtime=rt)["image"]
        return api.sobel_edge_detection(image, level=call.level,
                                        runtime=rt)["image"]

    def _call(self, call: schedule.Call):
        return self.fn(call, self.images[call.size][call.image])

    def counters(self) -> dict:
        return {"executables": self.runtime.executables.stats()}

    def release(self) -> None:
        self.runtime = self.fn = None
        self.api.set_device("cpu")
        _free_card()

    def check(self, cmp: Comparison) -> int:
        dev = self.ctx.device
        for call, out in self.sample.items:
            img = torch.from_numpy(self.images[call.size][call.image]).to(dev)
            want = reference.apply(img, call.filter, call.level, call.sigma,
                                   call.radius)
            cmp.add(torch.from_numpy(np.asarray(out)), want, call.filter,
                    call.level)
        return len(self.sample.items)


class ForwardEntry(_Loop):
    kind = "forward"

    def setup(self) -> None:
        from gpu_image_processing_tpu_torch.models.filters import get_filter

        mix, dev = self.ctx.mix, self.ctx.device
        self.models = {}
        for call in schedule.distinct_work(mix, self.ctx.config):
            params = {"level": call.level}
            if call.filter == "gaussian":
                params.update(sigma=call.sigma, radius=call.radius)
            elif call.filter == "box":
                params.update(radius=call.radius)
            self.models[call.key()] = get_filter(call.filter, **params).to(dev)
        self.fn = self._program
        if self.ctx.alter is not None:
            self.fn = self.ctx.alter(self.kind, self.fn)
        cfg = self.ctx.config["scene"]
        frames = image_pool(self.rng, (cfg["height"], cfg["width"]),
                            [tuple(s) for s in mix["sizes"]],
                            int(mix["pool"]))
        self.frames = {size: [torch.from_numpy(f).to(dev) for f in imgs]
                       for size, imgs in frames.items()}
        self._warm()
        # The allocator holds as many outputs as the sample keeps, so that
        # keeping one in the window allocates nothing new.
        held = [self._call(c) for c in schedule.distinct_work(
            mix, self.ctx.config) for _ in range(self.sample.k + 1)]
        del held

    def _program(self, call: schedule.Call, frame: torch.Tensor
                 ) -> torch.Tensor:
        return self.models[call.key()](frame)

    def _call(self, call: schedule.Call) -> torch.Tensor:
        out = self.fn(call, self.frames[call.size][call.image])
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.models = self.fn = None
        _free_card()

    def check(self, cmp: Comparison) -> int:
        for call, out in self.sample.items:
            frame = self.frames[call.size][call.image]
            want = reference.apply(frame, call.filter, call.level,
                                   call.sigma, call.radius)
            cmp.add(out, want, call.filter, call.level)
        return len(self.sample.items)


def _data_url(mime: str, payload: bytes) -> bytes:
    return f"data:{mime};base64,".encode() + base64.b64encode(payload)


def _png_of_data_url(url: str) -> np.ndarray:
    head, _, payload = url.partition(",")
    if head != "data:image/png;base64":
        raise png.PNGError(f"an answer of type {head[:40]!r}")
    return png.decode(base64.b64decode(payload))


@dataclass
class Upload:
    """One upload of the pool: its size, its index in the size's pool, the
    image made from the seed, its data URL and, for a JPEG, what the
    writer wrote (whose reference decode the server's is held to)."""

    size: tuple[int, int]
    index: int
    image: np.ndarray
    url: bytes
    written: jpeg.Written | None = None


#: Threads that send the warm-up's requests at once.
WARM_THREADS = 4


class HttpEntry:
    """The UI's server, in this process, and its clients, threads of one
    process of their own.

    The uploads are PNGs, or JPEGs where the mix says so (`upload`,
    `spec.check_mix`), written by `reference/jpeg.py` as a phone camera
    writes them.  Each call template is one request body: its filter and
    its `sigma` and `radius` (`schedule.params`), as the UI's sliders send
    them."""

    kind = "http"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.rng = np.random.default_rng(ctx.seed)

    def setup(self) -> None:
        from gpu_image_processing_tpu_torch.server.app import (
            create_app, start_runtime, warm_kernels)
        from gpu_image_processing_tpu_torch.server.http import AppServer

        ctx, mix = self.ctx, self.ctx.mix
        runtime, error = start_runtime(str(ctx.device))
        if runtime is None:
            raise RuntimeError(f"the server's runtime did not start: {error}")
        warm_kernels(runtime)
        served = runtime
        if ctx.alter is not None:
            served = _Altered(runtime, ctx.alter(self.kind, runtime.run))
        self.server = AppServer(create_app(served, str(ctx.device)),
                                "127.0.0.1", 0)
        self.server.start_background()
        self.base = f"http://127.0.0.1:{self.server.port}"
        cfg = ctx.config["scene"]
        sizes = [tuple(s) for s in mix["sizes"]]
        images = image_pool(self.rng, (cfg["height"], cfg["width"]), sizes,
                            int(mix["pool"]))
        self.uploads = [self._upload(size, i, img) for size in sizes
                        for i, img in enumerate(images[size])]
        # The UI sends its sliders' values with every filter.
        self.fields = [{"filter": t["filter"],
                        **schedule.params(t, ctx.config),
                        "enable_profiling": False} for t in mix["calls"]]
        ctx.log(f"portbench: uploads {len(self.uploads)} "
                f"{mix.get('upload', {}).get('format', 'png').upper()}, "
                f"{sum(len(u.url) for u in self.uploads)} data-URL bytes, "
                f"{[len(u.url) for u in self.uploads]}")
        self._start_clients()
        self._warm()

    def _upload(self, size: tuple[int, int], i: int, img: np.ndarray
                ) -> Upload:
        up = self.ctx.mix.get("upload")
        if up is None:
            return Upload(size, i, img, _data_url("image/png", png.encode(img)))
        t = time.perf_counter()
        written = jpeg.encode(img, up["quality"], up["subsampling"],
                              up["exif"])
        self.ctx.log(f"portbench: wrote a {img.shape[1]}x{img.shape[0]} JPEG "
                     f"(quality {up['quality']}, {up['subsampling']}) of "
                     f"{len(written.data)} bytes in "
                     f"{time.perf_counter() - t:.3f} s")
        return Upload(size, i, img, _data_url("image/jpeg", written.data),
                      written)

    def _plan(self, client: int) -> list[tuple[int, int]]:
        """Client `client`'s (upload, template) pairs: balanced blocks of
        the mix."""
        calls = schedule.calls(self.ctx.mix, self.ctx.config,
                               np.random.default_rng([self.ctx.seed, 3, client]))
        index = {(up.size, up.index): u for u, up in enumerate(self.uploads)}
        return [(index[(c.size, c.image)], c.template)
                for c in (next(calls) for _ in range(4096))]

    def _start_clients(self) -> None:
        """One process for the clients, each client a thread in it."""
        n = int(self.ctx.mix["clients"])
        self.plans = [self._plan(c) for c in range(n)]
        self.clients = subprocess.Popen([sys.executable, str(CLIENT)],
                                        stdin=subprocess.PIPE,
                                        stdout=subprocess.PIPE)
        hdr = {"host": "127.0.0.1", "port": self.server.port,
               "route": self.ctx.mix["route"],
               "upload_bytes": [len(u.url) for u in self.uploads],
               "fields": self.fields, "plans": self.plans,
               "sample": int(self.ctx.mix["sample"]),
               "sample_seeds": [int(self.rng.integers(2**62))
                                for _ in range(n)]}
        self.clients.stdin.write(json.dumps(hdr).encode() + b"\n")
        for u in self.uploads:
            self.clients.stdin.write(u.url)
        self.clients.stdin.flush()
        if self.clients.stdout.readline().strip() != b"ready":
            raise RuntimeError("the clients did not start")

    def _post(self, upload: int, template: int) -> int:
        body = json.dumps({**self.fields[template],
                           "image": self.uploads[upload].url.decode()}).encode()
        req = urllib.request.Request(self.base + self.ctx.mix["route"], body,
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            resp.read()
            return resp.status

    def _warm(self) -> None:
        """Every template on every upload size, `warm_repeats` rounds, up
        to `WARM_THREADS` requests at once: each key's first request, its
        capture, its replays.  The runtime keeps the executables of its
        last 8 keys (filter, level, shape, taps); a mix with more keys
        than that builds, captures and evicts inside the window too, and
        that churn is the deployment being measured, not a fault."""
        firsts = {}
        for u, up in enumerate(self.uploads):
            firsts.setdefault(up.size, u)
        jobs = [(u, t) for u in firsts.values()
                for t in range(len(self.fields))]
        with ThreadPoolExecutor(min(len(jobs), WARM_THREADS)) as pool:
            for _ in range(int(self.ctx.mix.get("warm_repeats", 3))):
                for status in pool.map(lambda j: self._post(*j), jobs):
                    if status != 200:
                        raise RuntimeError(f"a warm-up request answered {status}")

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path, timeout=60) as resp:
            return json.loads(resp.read())

    def counters(self) -> dict:
        stats = self._get(ROUTE_STATS)
        return {"phase": stats["phase_ms"].get(f"POST {self.ctx.mix['route']}",
                                               {}),
                "executables": stats["executables"],
                "decode_tiers": stats["decode_tiers"],
                "encode_bands": stats["encode_bands"]}

    def window(self, t0: float, t1: float) -> Window:
        self.clients.stdin.write(f"{t0!r} {t1!r}\n".encode())
        self.clients.stdin.flush()
        while time.perf_counter() < t1:
            time.sleep(min(0.05, max(t1 - time.perf_counter(), 0.0)))
        return Window()

    def collect(self, win: Window) -> Window:
        """Wait for every client's last reply; the window's calls, and the
        kept answers with what each asked."""
        proc = self.clients
        out = json.loads(proc.stdout.readline())
        upload_bytes = 0
        for sent, done, status, n, i in out["records"]:
            win.calls.append((sent, done, status == 200))
            plan = self.plans[n]
            upload_bytes += len(self.uploads[plan[i % len(plan)][0]].url)
        self.kept = [(self.plans[n][i % len(self.plans[n])],
                      proc.stdout.read(size)) for n, i, size in out["kept"]]
        proc.stdout.close()
        proc.stdin.close()
        proc.wait(timeout=120)
        self.clients = None
        win.notes.append(f"requests {len(win.calls)}, failed "
                         f"{sum(not ok for _, _, ok in win.calls)}, upload bytes "
                         f"{upload_bytes}, the clients' peak resident set "
                         f"{out['peak_rss_kib']} KiB")
        return win

    def release(self) -> None:
        self.server.shutdown()
        self.server = None
        _free_card()

    def check(self, cmp: Comparison) -> int:
        """Each kept reply: the original and every level the route
        promises (the configuration's `levels`); a level missing from a
        reply counts as an unreadable answer.

        A PNG upload's original is held to the upload's pixels, and each
        level to the reference filter of them.  A JPEG upload's is checked
        in two stages: (a) the reply's original, the server's decode, is
        held to the reference decode of what the writer wrote, within the
        configuration's `jpeg_decode` tolerance; (b) each level is held to
        the reference filter of that decoded original, under the
        configuration's other numerics, so that the filters stay exact
        whichever decoder the server runs.  A JPEG's original that cannot
        be read, or that is the upload passed back, is an unreadable
        answer, and its levels go unjudged."""
        dev = self.ctx.device
        promised = [int(v) for v in self.ctx.config["levels"]]
        want_cache: dict = {}
        reference_decodes: dict[int, torch.Tensor] = {}
        for (u, t), body in self.kept:
            up, fields = self.uploads[u], self.fields[t]
            f = fields["filter"]
            try:
                answer = json.loads(body)
                original = answer["original_image"]
                if not isinstance(original, str):
                    raise TypeError("the original is not a string")
                levels = {int(k.split("_")[1]): v["processed_image"]
                          for k, v in answer["results"].items()}
            except (ValueError, KeyError, AttributeError, IndexError,
                    TypeError) as exc:
                cmp.unreadable(f"{f}: reply not read ({exc.__class__.__name__})")
                continue
            if up.written is None:
                src = torch.from_numpy(up.image).to(dev)
                if original.encode() == up.url:
                    cmp.add(src, src, "original", 0)
                else:
                    self._add_png(cmp, original, src, "original", 0)
                source = u
            else:
                if u not in reference_decodes:
                    reference_decodes[u] = torch.from_numpy(
                        jpeg.decode(up.written))
                src = self._decoded(cmp, original, up, reference_decodes[u], f)
                if src is None:
                    continue
                src, source = src.to(dev), original
            for level in promised:
                if level not in levels:
                    cmp.unreadable(f"{f}: no level_{level} in the reply, "
                                   f"levels {sorted(levels)}")
            decoded: dict[str, torch.Tensor] = {}
            for level, url_out in sorted(levels.items()):
                key = (source, t, level if f == "sobel" else 0)
                if key not in want_cache:
                    want_cache[key] = reference.apply(
                        src, f, level, fields["sigma"], fields["radius"])
                self._add_png(cmp, url_out, want_cache[key], f, level,
                              decoded)
        return len(self.kept)

    @staticmethod
    def _decoded(cmp: Comparison, original: str, up: Upload,
                 want: torch.Tensor, f: str) -> torch.Tensor | None:
        """Stage (a): the server's decode of JPEG upload `up`, read from
        the reply's original and held to the reference decode `want`; None
        where it cannot be read."""
        if original.encode() == up.url:
            cmp.unreadable(f"{f}: the JPEG upload came back as the original, "
                           "not the server's decode of it")
            return None
        try:
            got = torch.from_numpy(_png_of_data_url(original))
        except (ValueError, zlib.error) as exc:
            cmp.unreadable(f"{f} original: {exc}")
            return None
        cmp.add_decode(got, want)
        return got if tuple(got.shape) == tuple(want.shape) else None

    @staticmethod
    def _add_png(cmp: Comparison, url: str, want: torch.Tensor, f: str,
                 level: int, decoded: dict | None = None) -> None:
        try:
            got = (decoded or {}).get(url)
            if got is None:
                got = torch.from_numpy(_png_of_data_url(url))
                if decoded is not None:
                    decoded[url] = got
        except (ValueError, zlib.error) as exc:
            cmp.unreadable(f"{f} L{level}: {exc}")
            return
        cmp.add(got, want, f, level)

    def close(self) -> None:
        if getattr(self, "clients", None) is not None:
            self.clients.kill()
            self.clients.wait(timeout=30)


class _Altered:
    """The server's runtime with its `run` replaced."""

    def __init__(self, runtime, run):
        self._runtime, self.run = runtime, run

    def __getattr__(self, name):
        return getattr(self._runtime, name)


ENTRIES = {"http": HttpEntry, "api": ApiEntry, "forward": ForwardEntry}
