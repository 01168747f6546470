"""Start the port's HTTP service under ``deploy/env.production.example``,
check it over HTTP, and stop it.

The service runs in a process of its own with every setting of the
example in its environment, the database moved to a temporary directory
and a token for both bots added (the user bot and the admin notifier
both read ``AMW_TELEGRAM_BOT_TOKEN``).  It is ``amw_tpu_torch.runtime.service.
main``, the function ``python -m amw_tpu_torch.runtime.service`` calls,
on a free port of 127.0.0.1, so that it can run beside another instance.
The checks: ``/api/health`` answers within ``--timeout`` seconds; the
initial admin of the example logs in and reads ``/api/admin/stats``;
``/api/version`` names the port and ``/api/extensions`` the backend
``torch-cuda``; the landing page's demo clips are in ``frontend/demos``
(the service renders them at start where they are missing); the service
exits 0 on SIGTERM.  Prints one JSON object, the last line ``{"ok":
true}`` or ``{"ok": false}``, and exits 1 where a check failed.

Run from the checkout's root on a machine with the card::

    python -m amw_tpu_torch.scripts.prod_start [--timeout 180]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DEMOS = ROOT / "frontend" / "demos"
DEMO_FILES = ("ballad_mastered.wav", "ballad_original.wav",
              "edm_mastered.wav", "edm_original.wav")


def production_env() -> dict:
    env = {}
    for line in (ROOT / "deploy" / "env.production.example").read_text(
            ).splitlines():
        line = line.strip()
        if line and not line.startswith("#") and "=" in line:
            k, v = line.split("=", 1)
            env[k.strip()] = v.strip()
    return env


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(base: str, path: str, body=None, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=180.0,
                    help="seconds to wait for health and for the demo clips")
    args = ap.parse_args()
    prod = production_env()
    tmp = tempfile.mkdtemp(prefix="amw_prod_")
    port = free_port()
    env = {**os.environ, **prod,
           "AMW_DB_PATH": os.path.join(tmp, "amw.sqlite3"),
           "AMW_TELEGRAM_BOT_TOKEN": "123:abc"}
    base = f"http://127.0.0.1:{port}"
    out: dict = {"port": port}
    checks: dict = {}
    log_path = os.path.join(tmp, "service.log")
    t0 = time.perf_counter()
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from amw_tpu_torch.runtime.service import main; "
         f"main(host='127.0.0.1', port={port})"],
        cwd=ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        while time.perf_counter() - t0 < args.timeout:
            if proc.poll() is not None:
                break
            try:
                out["health"] = call(base, "/api/health")[1]
                break
            except OSError:
                time.sleep(0.5)
        out["start_s"] = time.perf_counter() - t0
        checks["health"] = "health" in out
        if checks["health"]:
            status, login = call(base, "/api/auth/login", {
                "email": prod["AMW_ADMIN_EMAIL"],
                "password": prod["AMW_ADMIN_PASSWORD"]})
            out["admin"] = {k: login[k]
                            for k in ("email", "tier", "is_admin")}
            checks["admin_login"] = (status == 200
                                     and login["is_admin"] is True)
            status, stats = call(base, "/api/admin/stats",
                                 token=login["access_token"])
            checks["admin_stats"] = status == 200 and "users_total" in stats
            out["version"] = call(base, "/api/version")[1]
            checks["version"] = out["version"]["engine"] == "amw_tpu_torch"
            out["backend"] = call(base, "/api/extensions")[1]["backend"]
            checks["backend"] = out["backend"] == "torch-cuda"
            t_demo = time.perf_counter()
            while (not all((DEMOS / f).is_file() for f in DEMO_FILES)
                   and time.perf_counter() - t_demo < args.timeout):
                time.sleep(0.5)
            out["demo_files"] = sorted(p.name for p in DEMOS.glob("*.wav"))
            checks["demo_files"] = all(f in out["demo_files"]
                                       for f in DEMO_FILES)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log_file.close()
    out["rc"] = proc.returncode
    checks["exit_0"] = proc.returncode == 0
    out["checks"] = checks
    out["log_tail"] = Path(log_path).read_text(errors="replace")[-2000:]
    ok = all(checks.values()) and len(checks) == 7
    print(json.dumps(out))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
