"""Event-driven watch loop for the operator.

The port's copy of ``dynamo_tpu/deploy/watch.py``.

Reference analog: the Go controller's controller-runtime watch machinery
(deploy/dynamo/operator internal/controller — Reconcile is driven by
informer events, with a periodic resync). Same contract here without the
kubernetes client library: ``kubectl get --watch --output-watch-events``
is the event source, and every (re)connect starts with a full relist so
drift can never outlive a reconnect. The resync interval doubles as the
watch's request timeout — when it expires the stream ends, the loop
relists, and reconnects — which is exactly controller-runtime's resync
semantic expressed through kubectl.

The loop itself is transport-agnostic (it consumes any iterable of
watch-event dicts), so tests drive it from in-memory event lists.
"""

from __future__ import annotations

import codecs
import json
import logging
import subprocess
import time
from typing import Callable, Iterable, Iterator, List, Optional

from .operator import (GROUP, PLURAL, Reconciler, cr_key, relist_reconcile,
                       safe_finalize, safe_reconcile)

logger = logging.getLogger(__name__)


def iter_watch_events(chunks: Iterable[str]) -> Iterator[dict]:
    """Parse a stream of concatenated JSON watch events.

    kubectl emits pretty-printed JSON documents back to back (no
    delimiters beyond whitespace); chunks may split mid-document, so
    accumulate and decode greedily.
    """
    decoder = json.JSONDecoder()
    buf = ""
    for chunk in chunks:
        buf += chunk
        while True:
            stripped = buf.lstrip()
            if not stripped:
                buf = ""
                break
            try:
                event, end = decoder.raw_decode(stripped)
            except json.JSONDecodeError:
                buf = stripped  # incomplete document; wait for more
                break
            buf = stripped[end:]
            yield event


def watch_loop(
    reconciler: Reconciler,
    list_crs: Callable[[], Optional[List[dict]]],
    open_stream: Callable[[], Iterable[dict]],
    stop=None,                    # threading.Event-like; None = run forever
    reconnect_backoff_s: float = 2.0,
    max_backoff_s: float = 60.0,
) -> None:
    """Relist + reconcile, then apply watch events until the stream ends;
    repeat. DELETED events finalize; ADDED/MODIFIED reconcile; ERROR
    events (v1.Status payloads, e.g. 410 Gone on an expired
    resourceVersion) abandon the stream so the relist repairs state.

    A CR that disappears *between* streams — deleted while we were
    disconnected, so no DELETED event was ever observed — is caught by
    the relist diff, same as the poll loop. A cleanly-ended stream (the
    resync/request timeout on a quiet cluster) reconnects after the base
    delay; only failures grow the backoff.
    """
    seen: dict = {}
    backoff = reconnect_backoff_s
    while stop is None or not stop.is_set():
        listed = list_crs()
        if listed is None:
            # listing failed — never mistake an API error for "no CRs"
            if _wait(stop, backoff):
                return
            backoff = min(backoff * 2, max_backoff_s)
            continue
        seen = relist_reconcile(reconciler, listed, seen)
        backoff = reconnect_backoff_s  # the API is reachable again

        failed = False
        try:
            for event in open_stream():
                if stop is not None and stop.is_set():
                    return
                obj = event.get("object")
                etype = event.get("type")
                if not obj or etype == "BOOKMARK":
                    continue
                name = (obj.get("metadata") or {}).get("name")
                if etype == "ERROR" or not name:
                    # v1.Status error payload (410 Gone etc.): the stream
                    # is no longer trustworthy; relist and reconnect
                    logger.warning("watch: error event %s; relisting",
                                   json.dumps(event)[:200])
                    break
                key = cr_key(obj)
                if etype == "DELETED":
                    logger.info("watch: finalizing %s/%s", *key)
                    if safe_finalize(reconciler, obj):
                        seen.pop(key, None)
                    else:
                        # the CR stays in ``seen`` and is absent from
                        # every later listing → relist retries teardown
                        break
                else:  # ADDED / MODIFIED
                    seen[key] = obj
                    if not safe_reconcile(reconciler, obj):
                        # a quiet cluster would not produce another event
                        # for this CR until the resync timeout; abandon
                        # the stream so the relist retries within the
                        # base delay (the poll loop's 10s analog)
                        break
        except Exception:
            logger.exception("watch stream failed; relisting after %.0fs",
                             backoff)
            failed = True
        if _wait(stop, backoff if failed else reconnect_backoff_s):
            return
        if failed:
            backoff = min(backoff * 2, max_backoff_s)


def _wait(stop, seconds: float) -> bool:
    """True = stop requested."""
    if stop is not None:
        return stop.wait(seconds) if seconds else stop.is_set()
    if seconds:
        time.sleep(seconds)
    return False


def _decoded_chunks(raw) -> Iterator[str]:
    """Incrementally decode a BufferedReader's available bytes.

    ``read1`` returns as soon as *any* bytes are available — a
    TextIOWrapper.read(n) would block until n characters accumulate,
    stalling event delivery on quiet streams.
    """
    decode = codecs.getincrementaldecoder("utf-8")(errors="replace").decode
    while True:
        data = raw.read1(4096)
        if not data:
            return
        yield decode(data)


class KubectlWatchSource:
    """``open_stream`` over a real cluster: one kubectl watch process per
    call, bounded by the resync interval so the loop periodically
    relists (controller-runtime's resync)."""

    def __init__(self, kubectl: str = "kubectl",
                 namespace: Optional[str] = None,
                 resync_interval_s: float = 300.0):
        self.kubectl = kubectl
        self.namespace = namespace
        self.resync_interval_s = resync_interval_s

    def __call__(self) -> Iterator[dict]:
        args = [self.kubectl, "get", f"{PLURAL}.{GROUP}", "--watch",
                "--output-watch-events", "-o", "json",
                f"--request-timeout={int(self.resync_interval_s)}s"]
        args += (["-n", self.namespace] if self.namespace
                 else ["--all-namespaces"])
        proc = subprocess.Popen(args, stdout=subprocess.PIPE)
        try:
            yield from iter_watch_events(_decoded_chunks(proc.stdout))
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()  # kubectl ignored SIGTERM (stalled net read)
                proc.wait()
