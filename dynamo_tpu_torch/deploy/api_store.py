"""api-store: REST CRUD over deployment records, backed by sqlite.

The port's copy of ``dynamo_tpu/deploy/api_store.py`` (reference analog:
deploy/dynamo/api-store, the service the reference's CLI and operator use
to persist deployment records). The same routes, status codes and JSON
bodies; it serves on the port's own asyncio HTTP (``http/server.
RouteServer``), not aiohttp, so either package's ``ApiStoreClient`` talks
to it.

Run standalone:  python -m dynamo_tpu_torch.deploy.api_store --port 8790
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import sqlite3
import time
from typing import Optional

from ..http.server import RouteServer, json_response

logger = logging.getLogger(__name__)

DEFAULT_PORT = 8790


class DeploymentStore:
    """sqlite-backed document store: name → deployment spec (JSON)."""

    def __init__(self, path: str = ":memory:"):
        self.db = sqlite3.connect(path)
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS deployments ("
            " name TEXT PRIMARY KEY,"
            " spec TEXT NOT NULL,"
            " created REAL NOT NULL,"
            " updated REAL NOT NULL,"
            " status TEXT)"
        )
        try:  # migrate pre-status databases in place
            self.db.execute("ALTER TABLE deployments ADD COLUMN status TEXT")
        except sqlite3.OperationalError:
            pass
        self.db.commit()

    @staticmethod
    def _record(row) -> dict:
        n, s, c, u, st = row
        return {
            "name": n, "spec": json.loads(s), "created": c, "updated": u,
            "status": json.loads(st) if st else None,
        }

    def list(self) -> list:
        rows = self.db.execute(
            "SELECT name, spec, created, updated, status FROM deployments"
            " ORDER BY name"
        ).fetchall()
        return [self._record(r) for r in rows]

    def get(self, name: str) -> Optional[dict]:
        row = self.db.execute(
            "SELECT name, spec, created, updated, status FROM deployments"
            " WHERE name=?",
            (name,),
        ).fetchone()
        return None if row is None else self._record(row)

    def set_status(self, name: str, status: dict) -> bool:
        """Reconciler write-back: the store plays the CR's status
        subresource for store-sourced deployments."""
        cur = self.db.execute(
            "UPDATE deployments SET status=? WHERE name=?",
            (json.dumps(status), name),
        )
        self.db.commit()
        return cur.rowcount > 0

    def put(self, name: str, spec: dict) -> dict:
        now = time.time()
        existing = self.get(name)
        if existing is None:
            self.db.execute(
                "INSERT INTO deployments (name, spec, created, updated)"
                " VALUES (?, ?, ?, ?)",
                (name, json.dumps(spec), now, now),
            )
        else:
            self.db.execute(
                "UPDATE deployments SET spec=?, updated=? WHERE name=?",
                (json.dumps(spec), now, name),
            )
        self.db.commit()
        return self.get(name)  # type: ignore[return-value]

    def delete(self, name: str) -> bool:
        cur = self.db.execute("DELETE FROM deployments WHERE name=?", (name,))
        self.db.commit()
        return cur.rowcount > 0


class ApiStoreService:
    """The REST front over a DeploymentStore, on a ``RouteServer``."""

    def __init__(self, store: Optional[DeploymentStore] = None,
                 host: str = "0.0.0.0", port: int = DEFAULT_PORT):
        self.store = store or DeploymentStore()
        self.host = host
        self.port = port
        self.server = RouteServer(host, port)
        for method, path, handler in (
            ("GET", "/api/v1/deployments", self.handle_list),
            ("POST", "/api/v1/deployments", self.handle_create),
            ("GET", "/api/v1/deployments/{name}", self.handle_get),
            ("PUT", "/api/v1/deployments/{name}", self.handle_update),
            ("DELETE", "/api/v1/deployments/{name}", self.handle_delete),
            ("PUT", "/api/v1/deployments/{name}/status", self.handle_status),
            ("GET", "/health", self.handle_health),
        ):
            self.server.add_route(method, path, handler)

    async def start(self) -> None:
        await self.server.start()
        self.port = self.server.port
        logger.info("api-store on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        await self.server.stop()

    # ---------- handlers ----------

    async def handle_list(self, request, conn=None):
        return json_response({"deployments": self.store.list()})

    async def handle_get(self, request, conn=None):
        record = self.store.get(request.match_info["name"])
        if record is None:
            return json_response({"error": "not found"}, status=404)
        return json_response(record)

    async def handle_create(self, request, conn=None):
        try:
            body = request.json()
            name = body["name"]
            spec = body.get("spec", {})
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            return json_response({"error": f"invalid body: {e}"}, status=400)
        if not isinstance(spec, dict):
            # same contract as PUT — a stored non-dict spec would blow up
            # every consumer that renders manifests from the record
            return json_response(
                {"error": "spec must be a JSON object"}, status=400)
        if self.store.get(name) is not None:
            return json_response(
                {"error": f"deployment {name!r} exists"}, status=409)
        return json_response(self.store.put(name, spec), status=201)

    async def handle_update(self, request, conn=None):
        """PUT takes the SAME envelope as POST: {"spec": {...}} (name
        optional, must match the URL), so a spec that happens to hold a
        top-level "spec" key stays unambiguous."""
        name = request.match_info["name"]
        try:
            body = request.json()
        except json.JSONDecodeError as e:
            return json_response({"error": f"invalid body: {e}"}, status=400)
        if not isinstance(body, dict) or "spec" not in body:
            return json_response(
                {"error": 'body must be {"spec": {...}}'}, status=400)
        if body.get("name") not in (None, name):
            return json_response(
                {"error": "body name does not match URL"}, status=400)
        spec = body["spec"]
        if not isinstance(spec, dict):
            return json_response(
                {"error": "spec must be a JSON object"}, status=400)
        if self.store.get(name) is None:
            return json_response({"error": "not found"}, status=404)
        return json_response(self.store.put(name, spec))

    async def handle_status(self, request, conn=None):
        """Status subresource for store-sourced deployments (written by
        the operator's reconcile loop, read back via GET/list)."""
        name = request.match_info["name"]
        try:
            body = request.json()
        except json.JSONDecodeError as e:
            return json_response({"error": f"invalid body: {e}"}, status=400)
        if not isinstance(body, dict) or not isinstance(body.get("status"), dict):
            return json_response(
                {"error": 'body must be {"status": {...}}'}, status=400)
        if not self.store.set_status(name, body["status"]):
            return json_response({"error": "not found"}, status=404)
        return json_response(self.store.get(name))

    async def handle_delete(self, request, conn=None):
        if not self.store.delete(request.match_info["name"]):
            return json_response({"error": "not found"}, status=404)
        return json_response({"deleted": True})

    async def handle_health(self, request, conn=None):
        return json_response({"status": "ok"})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="dynamo-tpu api-store")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument("--db", default="dynamo_api_store.sqlite")
    args = parser.parse_args(argv)
    from ..utils.logging import setup_logging

    setup_logging(logging.INFO)

    async def run():
        service = ApiStoreService(DeploymentStore(args.db), args.host, args.port)
        await service.start()
        print(f"api-store listening on http://{args.host}:{service.port}",
              flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        try:
            await stop.wait()
        finally:
            await service.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
