"""Start, stop and inspect the port's servers: the REST backend and the web
UI's static frontend.

The counterpart of the JAX package's `scripts/serve.py` (`start
[--no-frontend]`, `stop`, `status`) and of the root `start_servers.py`
(`run`: both servers as children in the foreground, stopped together on
Ctrl-C or SIGTERM).

* backend: `python -m gpu_image_processing_tpu_torch.server.app --device
  DEVICE --host HOST --port PORT` (its `main()` builds every kernel before
  it listens);
* frontend: `python -m http.server FRONTEND_PORT` in the repository's
  `frontend/`, which only a checkout has: outside one, `start` and `run`
  refuse before they start anything unless given `--no-frontend`.

The backend runs in the directory that holds the package (a checkout's
root, or the installation's), from which `python -m` imports it.

`start` refuses a port already in use, launches each server in a session of
its own with its output in a log file, and waits for the backend's
`/api/health`; a backend that exits while starting fails the start with
its log's tail.  The PID and log files are `gip_torch_*` in the run
directory (the temporary directory, or `--run-dir`), so the JAX package's
launcher (`gip_tpu_*`) and this one never stop each other's servers.
`stop` sends SIGTERM to each server's session, waits up to
`STOP_TIMEOUT_S`, then SIGKILLs what is left.  A server is found by its PID
file only: the JAX launcher's stop-by-port needs `lsof`, which the card's
machine lacks.

Usage:
    python -m gpu_image_processing_tpu_torch.tools.serve start [--no-frontend]
    python -m gpu_image_processing_tpu_torch.tools.serve stop
    python -m gpu_image_processing_tpu_torch.tools.serve status
    python -m gpu_image_processing_tpu_torch.tools.serve run [--no-frontend]
  options: --device cuda|cpu  --host  --port 8000  --frontend-port 8080
           --run-dir DIR  --timeout SECONDS
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

from ..core import config
from ..core.files import ROOT_DIR, repo_file

BACKEND, FRONTEND = "backend", "frontend"
#: Seconds between a server's SIGTERM and its SIGKILL.
STOP_TIMEOUT_S = 15.0


def port_in_use(port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        return s.connect_ex(("127.0.0.1", port)) == 0


def pid_alive(pid: int) -> bool:
    """True while `pid` runs.  A zombie (exited, not reaped) has stopped
    once its last thread has: its main thread turns zombie first, while
    another thread (a CUDA driver's, tearing down) may still hold the
    process's sockets for a few hundred ms."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        status = dict(line.split(":", 1) for line in
                      Path(f"/proc/{pid}/status").read_text().splitlines())
    except OSError:
        return True
    return not (status["State"].split()[0] == "Z"
                and int(status["Threads"]) <= 1)


def _files(run_dir: str, name: str) -> tuple[Path, Path]:
    """(PID file, log file) of server `name`."""
    base = Path(run_dir) / f"gip_torch_{name}"
    return base.with_suffix(".pid"), base.with_suffix(".log")


def read_pid(run_dir: str, name: str) -> int | None:
    """The PID in `name`'s PID file, if that process still runs."""
    try:
        pid = int(_files(run_dir, name)[0].read_text().strip())
    except (OSError, ValueError):
        return None
    return pid if pid_alive(pid) else None


def backend_command(args) -> list[str]:
    return [sys.executable, "-m", "gpu_image_processing_tpu_torch.server.app",
            "--device", args.device, "--host", args.host,
            "--port", str(args.port)]


def frontend_command(args) -> list[str]:
    return [sys.executable, "-m", "http.server", str(args.frontend_port),
            "--bind", args.host]


def _spawn(cmd: list[str], cwd: Path, log: Path | None) -> subprocess.Popen:
    out = open(log, "ab") if log else subprocess.DEVNULL
    try:
        return subprocess.Popen(cmd, cwd=cwd, stdin=subprocess.DEVNULL,
                                stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    finally:
        if log:
            out.close()


def tail(path: Path, lines: int = 20) -> str:
    try:
        return "\n".join(path.read_text(errors="replace").splitlines()[-lines:])
    except OSError:
        return "(no log)"


def wait_healthy(port: int, timeout_s: float, proc: subprocess.Popen) -> str:
    """"healthy" once the backend on `port` answers /api/health with its
    device up, "no device" if it answers without one (CUDA asked for on a
    host without it), "exited" if `proc` ends first, "timeout" after
    `timeout_s` seconds."""
    url = f"http://127.0.0.1:{port}/api/health"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return "exited"
        try:
            with opener.open(url, timeout=5) as resp:
                body = json.loads(resp.read())
            if body.get("status") == "healthy":
                return "healthy" if body.get("gpu_available") else "no device"
        except (OSError, ValueError):
            pass
        time.sleep(0.25)
    return "timeout"


def _wait_port(port: int, proc: subprocess.Popen, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and proc.poll() is None:
        if port_in_use(port):
            return True
        time.sleep(0.1)
    return False


def _terminate(pid: int, timeout_s: float) -> bool:
    """SIGTERM `pid`'s session, wait up to `timeout_s`, then SIGKILL it;
    True if it had to be killed."""
    try:
        pgid = os.getpgid(pid)
    except ProcessLookupError:
        return False
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return False
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not pid_alive(pid):
            return False
        time.sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        return False
    return True


def _check_ports(args, with_frontend: bool) -> bool:
    busy = [p for p in (args.port, *([args.frontend_port] if with_frontend
                                      else [])) if port_in_use(p)]
    for port in busy:
        print(f"Port {port} already in use")
    return not busy


def _start_backend(args, log: Path | None) -> subprocess.Popen | None:
    proc = _spawn(backend_command(args), ROOT_DIR, log)
    print(f"Backend starting on {args.device} (pid {proc.pid}"
          + (f", log {log}" if log else "") + ") ...", flush=True)
    state = wait_healthy(args.port, args.timeout, proc)
    if state == "healthy":
        print(f"Backend healthy on http://127.0.0.1:{args.port}", flush=True)
        return proc
    if state == "exited":
        print(f"Backend exited with code {proc.returncode} while starting")
    else:
        print(f"Backend on {args.device} has no device; stopping it"
              if state == "no device" else
              f"Backend not healthy after {args.timeout:.0f} s; stopping it")
        _terminate(proc.pid, STOP_TIMEOUT_S)
    if log:
        print(tail(log))
    return None


def _start_frontend(args, directory: Path,
                    log: Path | None) -> subprocess.Popen | None:
    proc = _spawn(frontend_command(args), directory, log)
    if not _wait_port(args.frontend_port, proc, 15.0):
        print(f"Frontend did not listen on port {args.frontend_port}")
        _terminate(proc.pid, STOP_TIMEOUT_S)
        return None
    print(f"Frontend on http://127.0.0.1:{args.frontend_port} (pid {proc.pid})",
          flush=True)
    return proc


def cmd_start(args) -> int:
    with_frontend = args.frontend_dir is not None
    if not _check_ports(args, with_frontend):
        return 1
    Path(args.run_dir).mkdir(parents=True, exist_ok=True)
    pid_file, log = _files(args.run_dir, BACKEND)
    backend = _start_backend(args, log)
    if backend is None:
        return 1
    pid_file.write_text(str(backend.pid))
    if with_frontend:
        frontend_pid, log = _files(args.run_dir, FRONTEND)
        frontend = _start_frontend(args, args.frontend_dir, log)
        if frontend is None:
            _terminate(backend.pid, STOP_TIMEOUT_S)
            pid_file.unlink(missing_ok=True)
            return 1
        frontend_pid.write_text(str(frontend.pid))
    return 0


def cmd_stop(args) -> int:
    for name, port in ((BACKEND, args.port), (FRONTEND, args.frontend_port)):
        pid = read_pid(args.run_dir, name)
        if pid:
            killed = _terminate(pid, STOP_TIMEOUT_S)
            print(f"Stopped {name} (pid {pid}{', killed' if killed else ''})")
        elif port_in_use(port):
            print(f"{name}: port {port} in use, but no PID file names its "
                  f"process; not stopped")
        else:
            print(f"{name} not running")
        _files(args.run_dir, name)[0].unlink(missing_ok=True)
    return 0


def cmd_status(args) -> int:
    for name, port in ((BACKEND, args.port), (FRONTEND, args.frontend_port)):
        pid = read_pid(args.run_dir, name)
        print(f"{name}: pid={pid or '-'} "
              f"port_{port}={'up' if port_in_use(port) else 'down'}")
    return 0


def cmd_run(args) -> int:
    """Both servers as children in the foreground until Ctrl-C or SIGTERM,
    or until one exits; then both stop."""
    with_frontend = args.frontend_dir is not None
    if not _check_ports(args, with_frontend):
        return 1
    stopping = []

    def request_stop(_sig, _frame):
        stopping.append(True)

    signal.signal(signal.SIGTERM, request_stop)
    signal.signal(signal.SIGINT, request_stop)
    procs: list[tuple[str, subprocess.Popen]] = []
    rc = 1
    try:
        backend = _start_backend(args, None)
        if backend is None:
            return 1
        procs.append((BACKEND, backend))
        if with_frontend:
            frontend = _start_frontend(args, args.frontend_dir, None)
            if frontend is None:
                return 1
            procs.append((FRONTEND, frontend))
        print("Press Ctrl+C to stop the servers", flush=True)
        while not stopping:
            ended = [(n, p) for n, p in procs if p.poll() is not None]
            if ended:
                name, proc = ended[0]
                print(f"{name} exited (code {proc.returncode}); shutting down")
                return 1 if proc.returncode else 0
            time.sleep(0.2)
        rc = 0
        return rc
    finally:
        for name, proc in procs:
            if proc.poll() is None:
                print(f"  stopping {name} (pid {proc.pid})")
                _terminate(proc.pid, STOP_TIMEOUT_S)
            proc.wait()
        if procs:
            print("Servers stopped.", flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("command", choices=["start", "stop", "status", "run"])
    parser.add_argument("--no-frontend", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, for the backend")
    parser.add_argument("--host", default=config.BACKEND_HOST,
                        help="the address both servers bind")
    parser.add_argument("--port", type=int, default=config.BACKEND_PORT)
    parser.add_argument("--frontend-port", type=int,
                        default=config.FRONTEND_PORT)
    parser.add_argument("--run-dir", default=tempfile.gettempdir(),
                        help="where the gip_torch_* PID and log files live")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds to wait for the backend's health")
    args = parser.parse_args(argv)
    args.frontend_dir = None
    if args.command in ("start", "run") and not args.no_frontend:
        # Refuse before anything starts where there is no web UI.
        try:
            args.frontend_dir = repo_file(
                "frontend/", "pass --no-frontend to serve the API alone")
        except FileNotFoundError as exc:
            print(exc, file=sys.stderr)
            return 1
    return {"start": cmd_start, "stop": cmd_stop, "status": cmd_status,
            "run": cmd_run}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
