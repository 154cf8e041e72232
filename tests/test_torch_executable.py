"""The runtime's executables (runtime/executable.py): one per key, built
once, reused for every request of its key, bounded, and answering with
arrays of the caller's own.

On the CPU the executable serves the plain versions eagerly with the same
buffers, lock, reuse and copy-out as on the card, so these tests hold that
layer against the numpy oracle (`tests/oracle_numpy.py`) and the JAX
runtime with tolerance 0 where the numerics contract says bit-exact
(gaussian and box at levels 1 and 2; Sobel on grey images).  The
`cuda`-marked tests hold a replayed graph against an eager launch on the
card.
"""

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.runtime.dispatch import RUNTIME as JAX_RUNTIME
from gpu_image_processing_tpu_torch.core import config
from gpu_image_processing_tpu_torch.core.params import normalize_level
from gpu_image_processing_tpu_torch.ops.cuda import (
    LAUNCHES,
    api,
    count_launch,
    counted_apart,
)
from gpu_image_processing_tpu_torch.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.runtime.executable import (
    ExecutableCache,
    FilterExecutable,
    batch_cache_key,
    executable_cache_key,
)

from . import oracle_numpy as oracle
from .conftest import make_image

CPU = torch.device("cpu")


def _oracle(name: str, img: np.ndarray, sigma: float, radius: int,
            level: int) -> np.ndarray:
    if name == "gaussian":
        return oracle.gaussian_blur(img, gaussian_kernel_f32(radius, sigma),
                                    radius)
    if name == "box":
        return oracle.box_blur(img, radius)
    return oracle.sobel(img, level)


def test_keys_hold_the_taps_and_drop_sobels_radius():
    taps = gaussian_kernel_f32(3, 2.0)
    key = executable_cache_key("gaussian", 2, 10, 12, 3, 3, taps, CPU)
    assert key == ("gaussian", 2, 1, 10, 12, 3, 3, taps.tobytes(), "cpu")
    other = executable_cache_key("gaussian", 2, 10, 12, 3, 3,
                                 gaussian_kernel_f32(3, 2.5), CPU)
    assert other != key and other[:7] == key[:7]
    assert (executable_cache_key("sobel", 2, 10, 12, 3, 1, None, CPU)
            == executable_cache_key("sobel", 2, 10, 12, 3, 5, None, CPU)
            == ("sobel", 2, 1, 10, 12, 3, None, None, "cpu"))
    assert batch_cache_key("box", 2, 4, 10, 12, 3, 5, None, CPU) == (
        "batch", "box", 2, 4, 10, 12, 3, 5, None, "cpu")


@pytest.mark.parametrize("name,level", [("gaussian", 1), ("gaussian", 2),
                                        ("box", 2), ("sobel", 2)])
def test_two_requests_of_one_key_return_independent_arrays(rng, name, level):
    rt = FilterRuntime("cpu")
    img = make_image(rng, 14, 17, 1 if name == "sobel" else 3)
    want = _oracle(name, img, 2.0, 3, level)
    first, _ = rt.run(name, img, level=level, sigma=2.0, radius=3)
    exe = next(iter(rt.executables.values()))
    second, _ = rt.run(name, img, level=level, sigma=2.0, radius=3)
    assert len(rt.executables) == 1
    assert next(iter(rt.executables.values())) is exe
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
    assert not np.shares_memory(first, second)
    # Mutating one answer, or serving another image on the same key,
    # leaves the first answer as it was.
    second[:] = 7
    rt.run(name, make_image(rng, 14, 17, img.shape[2]), level=level,
           sigma=2.0, radius=3)
    np.testing.assert_array_equal(first, want)


@pytest.mark.parametrize("level", [1, 2, 4])
def test_two_sigmas_at_one_radius_are_two_keys(rng, level):
    rt = FilterRuntime("cpu")
    img = make_image(rng, 13, 16, 3)
    outs = {s: rt.gaussian_blur(img, sigma=s, radius=3, level=level)[0]
            for s in (1.0, 2.5)}
    assert len(rt.executables) == 2
    for sigma, out in outs.items():
        want = _oracle("gaussian", img, sigma, 3, level)
        if level == 4:
            # The level-4 band (r >= 3) is within 1 of level 2.
            assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(out, want)
    assert not np.array_equal(outs[1.0], outs[2.5])


def test_cache_keeps_its_limit_and_an_evicted_key_rebuilds(rng):
    rt = FilterRuntime("cpu")
    limit = config.EXECUTABLE_CACHE_SIZE
    img = make_image(rng, 9, 11, 3)
    first, _ = rt.box_blur(img, radius=1, level=2)
    first_exe = next(iter(rt.executables.values()))
    for radius in range(2, limit + 3):
        rt.box_blur(img, radius=radius, level=2)
        assert len(rt.executables) <= limit
    assert len(rt.executables) == limit
    assert rt.executables.evictions == 2
    assert [k[6] for k in rt.executables] == list(range(3, limit + 3))
    again, _ = rt.box_blur(img, radius=1, level=2)
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(again, oracle.box_blur(img, 1))
    rebuilt = rt.executables.values()[-1]
    assert rebuilt.key[6] == 1 and rebuilt is not first_exe and rebuilt.built


def test_cache_evicts_the_least_recently_used():
    cache = ExecutableCache(2)
    made = {k: FilterExecutable(k, lambda: None, (1, 1), CPU) for k in "abc"}
    for k in "ab":
        cache.get(k, lambda k=k: made[k])
    assert cache.get("a", lambda: pytest.fail("a is held")) is made["a"]
    cache.get("c", lambda: made["c"])
    assert list(cache) == ["a", "c"] and cache.evictions == 1


def test_cpu_cache_holds_no_pinned_or_device_bytes(rng):
    rt = FilterRuntime("cpu")
    rt.sobel_edge_detection(make_image(rng, 8, 9, 3), 2)
    stats = rt.executables.stats()
    assert stats.pop("build_ms") > 0   # host time of the one build
    assert stats == {
        "executables": 1, "captured": 0,
        "limit": config.EXECUTABLE_CACHE_SIZE, "evictions": 0,
        "requests": 1, "hits": 0, "builds": 1, "captures": 0,
        "capture_ms": 0.0, "pinned_bytes": 0, "device_bytes": 0}


def test_cache_counts_requests_and_the_keys_it_held(rng):
    rt = FilterRuntime("cpu")
    img = make_image(rng, 8, 9, 3)
    for sigma in (1.0, 1.1, 1.0, 1.0):   # a new sigma is a new key
        rt.gaussian_blur(img, sigma=sigma, radius=2, level=2)
    rt.run_all_levels("box", img, radius=2)   # two keys, none held
    stats = rt.executables.stats()
    assert (stats["requests"], stats["hits"], stats["executables"]) == (6, 2, 4)
    assert sorted(e.requests for e in rt.executables.values()) == [1, 1, 1, 3]
    assert not any(e.captured for e in rt.executables.values())   # no card


def test_a_key_is_staged_from_its_second_request(rng):
    rt = FilterRuntime("cpu")
    img = make_image(rng, 9, 10, 3)
    want = oracle.box_blur(img, 2)
    out, _ = rt.box_blur(img, radius=2, level=2)
    (exe,) = rt.executables.values()
    assert exe._host_in is None and exe._parts == []   # copied as it stands
    np.testing.assert_array_equal(out, want)
    for _ in range(2):
        out, _ = rt.box_blur(img, radius=2, level=2)
        assert exe._host_in is not None and len(exe._parts) == 1
        np.testing.assert_array_equal(out, want)
    assert exe.requests == 3


def test_a_capturing_thread_counts_its_launches_apart():
    before = LAUNCHES.copy()
    inside, outside = threading.Event(), threading.Event()

    def other() -> None:
        inside.wait()
        count_launch("sobel_rows")   # another thread, meanwhile
        outside.set()

    th = threading.Thread(target=other)
    th.start()
    with counted_apart() as mine:
        count_launch("gaussian_rows")
        inside.set()
        outside.wait()
        count_launch("gaussian_rows")
    th.join()
    count_launch("box_rows")
    assert mine == {"gaussian_rows": 2}
    assert LAUNCHES - before == {"sobel_rows": 1, "box_rows": 1}
    LAUNCHES.subtract({"sobel_rows": 1, "box_rows": 1})


@pytest.mark.parametrize("mixed", [False, True], ids=["one key", "mixed keys"])
def test_threads_equal_the_one_thread_answer(rng, mixed):
    imgs = [make_image(rng, 11 + i, 13, 3) for i in range(3)]
    cases = [("gaussian", imgs[0], 2, 2.0, 3), ("box", imgs[1], 1, 2.0, 4),
             ("sobel", imgs[2], 2, 2.0, 3), ("gaussian", imgs[0], 4, 1.5, 2)]
    if not mixed:
        cases = cases[:1]
    want = {i: FilterRuntime("cpu").run(f, img, level=lv, sigma=s, radius=r)[0]
            for i, (f, img, lv, s, r) in enumerate(cases)}
    rt = FilterRuntime("cpu")
    got: dict[tuple[int, int], np.ndarray] = {}
    errors: list[BaseException] = []
    start = threading.Barrier(8)

    def worker(t: int) -> None:
        try:
            start.wait()
            for rep in range(3):
                i = (t + rep) % len(cases)
                f, img, lv, s, r = cases[i]
                got[(t, rep)] = (i, rt.run(f, img, level=lv, sigma=s,
                                           radius=r)[0])
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert len(got) == 24
    for i, out in got.values():
        np.testing.assert_array_equal(out, want[i])
    assert len(rt.executables) == len(cases)


@pytest.mark.parametrize("name", ["gaussian", "box"])
def test_run_all_levels_equals_the_jax_runtime(rng, name):
    img = make_image(rng, 18, 23, 3)
    got = FilterRuntime("cpu").run_all_levels(name, img, sigma=2.0, radius=3)
    for lv, (out, _) in got.items():
        want, _ = JAX_RUNTIME.run(name, img, level=lv, sigma=2.0, radius=3)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, _oracle(name, img, 2.0, 3, lv))


def test_run_all_levels_sobel_on_grey_equals_the_jax_runtime(rng):
    img = make_image(rng, 18, 23, 1)
    got = FilterRuntime("cpu").run_all_levels("sobel", img)
    for lv, (out, _) in got.items():
        want, _ = JAX_RUNTIME.run("sobel", img, level=lv)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("name,kwargs,channels", [
    ("gaussian", {"sigma": 2.0, "radius": 3}, 3),
    ("box", {"radius": 2}, 3),
    ("sobel", {}, 1),
])
@pytest.mark.parametrize("level", [1, 2])
def test_run_batch_twice_equals_the_jax_runtime(rng, name, kwargs, channels,
                                                level):
    rt = FilterRuntime("cpu")
    for _ in range(2):   # the second batch replays the first's executable
        imgs = np.stack([make_image(rng, 10, 12, channels) for _ in range(3)])
        got, _ = rt.run_batch(name, imgs, level=level, **kwargs)
        want, _ = JAX_RUNTIME.run_batch(name, imgs, level=level, **kwargs)
        np.testing.assert_array_equal(got, want)
    assert len(rt.executables) == 1


def test_a_failed_build_raises_and_builds_again():
    calls = []

    def make():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("the kernel refused the shape")
        return lambda rows: rows + 1

    exe = FilterExecutable(("k",), make, (2, 3), CPU)
    rows = np.zeros((2, 3), np.uint8)
    with pytest.raises(RuntimeError, match="refused"):
        with exe.staged(rows):
            pass
    assert not exe.built
    with exe.staged(rows):
        out = exe.fetch(exe.run())
    np.testing.assert_array_equal(out, np.ones((2, 3), np.uint8))


def test_launch_once_builds_no_executable(rng):
    rt = FilterRuntime("cpu")
    img = make_image(rng, 8, 8, 3)
    out = rt.launch_once("box", img, 2, radius=2)
    np.testing.assert_array_equal(out, oracle.box_blur(img, 2))
    assert len(rt.executables) == 0


# -- on the card ---------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,radius", [("gaussian", 3), ("gaussian", 2),
                                         ("box", 5), ("box", 70),
                                         ("sobel", 3)])
@pytest.mark.parametrize("level", [1, 2, 4])
def test_graph_replay_equals_an_eager_launch(rng, name, radius, level):
    dev = _card()
    img = make_image(rng, 61, 97, 3)
    rt = FilterRuntime(dev)
    taps = gaussian_kernel_f32(radius, 1.5) if name == "gaussian" else None
    fn = api.rows_function(name, normalize_level(name, level), radius, 3, 97,
                           taps, dev)
    rows = torch.from_numpy(img.reshape(61, -1)).to(dev)
    before = LAUNCHES.copy()
    eager = fn(rows).cpu().numpy().reshape(img.shape)
    eager_launches = LAUNCHES - before
    # The key's first request runs eagerly on the staging; its second
    # captures the graph and replays it.
    for request, graph in ((1, False), (2, True)):
        before = LAUNCHES.copy()
        served, _ = rt.run(name, img, level=level, sigma=1.5, radius=radius)
        (exe,) = rt.executables.values()
        assert (exe.requests, exe.captured) == (request, graph)
        assert exe.pinned_bytes() == (2 * img.size if graph else 0)
        np.testing.assert_array_equal(served, eager)
        # An untimed run (after the build, or after the capture),
        # TIMING_REPS timed runs, and any timed run that went again because
        # the card idled (runtime/timing.py): each the eager launches.
        made = LAUNCHES - before
        runs = (max(made[k] // n for k, n in eager_launches.items())
                if eager_launches else 1 + config.TIMING_REPS)
        assert runs >= 1 + config.TIMING_REPS
        assert made == Counter({k: n * runs for k, n in eager_launches.items()})
    assert exe.launches == eager_launches
    before = LAUNCHES.copy()
    with exe.staged(img.reshape(61, -1)):
        replayed = exe.fetch(exe.run()).reshape(img.shape)
    assert LAUNCHES - before == eager_launches
    np.testing.assert_array_equal(replayed, eager)


@pytest.mark.cuda
def test_a_capture_error_raises():
    dev = _card()

    def syncs(rows):
        torch.cuda.synchronize()   # not allowed while a graph is captured
        return rows + 1

    exe = FilterExecutable(("k",), lambda: syncs, (4, 6), dev)
    rows = np.zeros((4, 6), np.uint8)
    with exe.staged(rows):   # the first request: eager, no capture
        pass
    assert exe.built and not exe.captured
    for _ in range(2):   # each later request tries the capture and raises
        with pytest.raises(RuntimeError):
            with exe.staged(rows):
                pytest.fail("served without its graph")
        assert not exe.captured


def test_staging_in_chunks_keeps_every_byte(rng, monkeypatch):
    from gpu_image_processing_tpu_torch.runtime import executable

    # Chunks of 100 bytes: the rows cross the staging in 24 pieces, the
    # last one short, each way.
    monkeypatch.setattr(executable, "STAGE_CHUNK", 100)
    rt = FilterRuntime("cpu")
    img = make_image(rng, 17, 47, 3)
    for _ in range(2):
        out, _ = rt.box_blur(img, radius=2, level=2)
        np.testing.assert_array_equal(out, oracle.box_blur(img, 2))
        img = make_image(rng, 17, 47, 3)
    (exe,) = rt.executables.values()
    assert len(exe._parts) == 24 and exe._parts[-1] == slice(2300, 2397)
