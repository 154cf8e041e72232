"""Live-API client: sequential checks against a running server.

The port's counterpart of the root `test_client.py` (itself the analog of
the reference's backend/test_client.py:202-258): ten checks in order (root,
health, filter catalog, gaussian and box at level 2, process-all level 1
against level 2, the batch endpoint, Sobel at level 4, a Radiance HDR
upload through the native decoder tier, stats), the returned images saved
as PNG, then a PASS/FAIL summary and an exit code that is 0 only if every
check passed.  It builds its images with the port's own codec
(utils/native_codec.py), so it needs no Pillow.

Usage:
    python -m gpu_image_processing_tpu_torch.tools.client
        [--base http://localhost:8000] [--outdir DIR]
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import tempfile
import urllib.request

import numpy as np

from ..utils import native_codec

_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http_json(url: str, payload: dict | None = None, timeout: float = 600.0):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {},
        method="POST" if data else "GET")
    with _OPENER.open(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def make_test_image() -> str:
    """A synthetic test card (gradients and shapes) as a PNG data URL."""
    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 / w).astype(np.uint8),
                    (yy * 255 / h).astype(np.uint8),
                    ((xx + yy) * 255 / (w + h)).astype(np.uint8)], axis=2)
    img[60:180, 80:240] = [255, 255, 255]
    img[100:140, 120:200] = [0, 0, 0]
    png = native_codec.png_encode(img)
    return "data:image/png;base64," + base64.b64encode(png).decode()


def make_hdr_upload() -> str:
    """A 24x32 Radiance HDR file (a grey-green ramp), written by
    `native_codec.hdr_write`, as base64."""
    img = np.zeros((24, 32, 3), np.uint8)
    img[..., 0] = 64
    img[..., 1] = np.linspace(0, 255, 32, dtype=np.uint8)
    fd, path = tempfile.mkstemp(suffix=".hdr")
    os.close(fd)
    try:
        if not native_codec.hdr_write(path, img):
            raise RuntimeError("native HDR write failed")
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()
    finally:
        os.unlink(path)


def save_png(data_url: str, path: str) -> None:
    with open(path, "wb") as f:
        f.write(base64.b64decode(data_url.split(",", 1)[1]))


def run_checks(base: str, outdir: str) -> int:
    """Run the checks in order, print each and the summary; 0 if all pass."""
    results: list[bool] = []

    def record(name: str, ok: bool, detail: str = "") -> None:
        results.append(ok)
        print(f"[{'PASS' if ok else 'FAIL'}] {name}"
              + (f" -- {detail}" if detail else ""), flush=True)

    os.makedirs(outdir, exist_ok=True)
    base = base.rstrip("/")
    image_b64 = make_test_image()

    # 1. root
    try:
        status, body = http_json(f"{base}/")
        record("root endpoint", status == 200 and body.get("status") == "running")
    except Exception as exc:
        record("root endpoint", False, str(exc))
        print("Server unreachable; aborting.")
        return 1

    # 2. health
    try:
        status, body = http_json(f"{base}/api/health")
        record("health check", status == 200 and body.get("status") == "healthy",
               f"accelerator={body.get('gpu_available')}")
    except Exception as exc:
        record("health check", False, str(exc))

    # 3. filter catalog
    try:
        status, body = http_json(f"{base}/api/filters")
        ok = status == 200 and set(body.get("filters", {})) == {"gaussian", "box", "sobel"}
        record("filter catalog", ok)
    except Exception as exc:
        record("filter catalog", False, str(exc))

    # 4. gaussian level 2
    try:
        status, body = http_json(f"{base}/api/process", {
            "image": image_b64, "filter": "gaussian", "level": 2,
            "sigma": 2.0, "radius": 3})
        ok = status == 200 and body["metrics"]["time_ms"] > 0
        if ok:
            save_png(body["processed_image"], f"{outdir}/gaussian_l2.png")
        record("gaussian blur level 2", ok,
               f"{body['metrics']['time_ms']:.3f} ms" if ok else "")
    except Exception as exc:
        record("gaussian blur level 2", False, str(exc))

    # 5. box blur level 2
    try:
        status, body = http_json(f"{base}/api/process", {
            "image": image_b64, "filter": "box", "level": 2, "radius": 5})
        ok = status == 200 and body["info"]["level"] == "shared_memory"
        if ok:
            save_png(body["processed_image"], f"{outdir}/box_l2.png")
        record("box blur level 2", ok)
    except Exception as exc:
        record("box blur level 2", False, str(exc))

    # 6. gaussian level 1 against level 2 through process-all
    try:
        status, body = http_json(f"{base}/api/process-all", {
            "image": image_b64, "filter": "gaussian", "sigma": 2.0, "radius": 3})
        r = body["results"]
        ok = status == 200 and "level_1" in r and "level_2" in r
        if ok:
            t1 = r["level_1"]["metrics"]["time_ms"]
            t2 = r["level_2"]["metrics"]["time_ms"]
            save_png(r["level_1"]["processed_image"], f"{outdir}/gaussian_l1.png")
            record("process-all L1 vs L2", True,
                   f"L1={t1:.3f} ms, L2={t2:.3f} ms, speedup={t1 / t2:.2f}x")
        else:
            record("process-all L1 vs L2", False, f"status={status}")
    except Exception as exc:
        record("process-all L1 vs L2", False, str(exc))

    # 7. the batch endpoint
    try:
        status, body = http_json(f"{base}/api/process-batch", {
            "images": [image_b64, image_b64], "filter": "box", "level": 2,
            "radius": 3})
        ok = status == 200 and body["metrics"]["batch_size"] == 2
        record("batch endpoint", ok,
               f"{body['metrics']['images_per_second']:.1f} img/s" if ok else "")
    except Exception as exc:
        record("batch endpoint", False, str(exc))

    # 8. the ADVANCED level
    try:
        status, body = http_json(f"{base}/api/process", {
            "image": image_b64, "filter": "sobel", "level": 4})
        ok = status == 200 and body["info"]["level"] == "advanced"
        if ok:
            save_png(body["processed_image"], f"{outdir}/sobel_l4.png")
        record("sobel ADVANCED level", ok)
    except Exception as exc:
        record("sobel ADVANCED level", False, str(exc))

    # 9. format breadth: only the native decoder tier reads Radiance HDR.
    try:
        status, body = http_json(f"{base}/api/process", {
            "image": make_hdr_upload(), "filter": "gaussian", "level": 2,
            "sigma": 2.0, "radius": 3})
        ok = status == 200 and body["metrics"]["time_ms"] > 0
        tiers = {}
        if ok:
            _, stats = http_json(f"{base}/api/stats")
            tiers = stats.get("decode_tiers", {})
            ok = tiers.get("native_hdr", 0) >= 1
        record("HDR upload via native tier", ok,
               f"native_hdr={tiers.get('native_hdr')}" if tiers else "")
    except Exception as exc:
        record("HDR upload via native tier", False, str(exc))

    # 10. stats
    try:
        status, body = http_json(f"{base}/api/stats")
        launches = sum(body.get("kernel_launches", {}).values())
        record("stats endpoint", status == 200 and body["requests_total"] > 0,
               f"{launches} kernel launches")
    except Exception as exc:
        record("stats endpoint", False, str(exc))

    passed = sum(results)
    print(f"\n{passed}/{len(results)} tests passed; images in {outdir}")
    return 0 if passed == len(results) else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", default="http://localhost:8000")
    parser.add_argument("--outdir", default=os.path.join(
        tempfile.gettempdir(), "gip_torch_client_test"))
    args = parser.parse_args(argv)
    return run_checks(args.base, args.outdir)


if __name__ == "__main__":
    sys.exit(main())
