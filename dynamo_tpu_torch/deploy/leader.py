"""Lease-based leader election for operator replicas.

The port's copy of ``dynamo_tpu/deploy/leader.py``.

Reference analog: the Go operator's controller-runtime leader election
(cmd/main.go ``LeaderElection`` flag) — a coordination.k8s.io/v1 Lease
is the lock; the holder renews it, everyone else retries, and a holder
that cannot renew must stop leading before the lease expires.

Same protocol here through a compare-and-swap client interface:
``read`` returns (lease-spec, version); ``write`` commits only if the
version still matches (optimistic concurrency). ``InMemoryLeases``
backs tests; ``KubectlLeases`` maps the CAS onto ``kubectl create``
(only-if-absent) and ``kubectl replace`` with resourceVersion (k8s
rejects a stale version as Conflict).

Clock discipline: expiry is judged with the LOCAL monotonic clock
against when *we* observed a renewTime change — never by parsing the
holder's wall-clock timestamp — so clock skew between replicas cannot
cause two leaders. A fresh observer therefore always waits a full
``lease_duration_s`` before its first takeover attempt.
"""

from __future__ import annotations

import json
import logging
import re
import subprocess
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Dict, Optional, Protocol, Tuple

logger = logging.getLogger(__name__)


class LeaseClient(Protocol):
    def read(self, namespace: str, name: str) -> Tuple[Optional[dict], Optional[str]]:
        """(lease spec, version), or (None, None) when absent."""
        ...

    def write(self, namespace: str, name: str, spec: dict,
              expected_version: Optional[str]) -> bool:
        """CAS commit. expected_version None = create-only-if-absent.
        Returns False on conflict (someone else wrote first)."""
        ...


class InMemoryLeases:
    """Test double with real CAS semantics."""

    def __init__(self) -> None:
        self._data: Dict[tuple, Tuple[dict, int]] = {}
        self._lock = threading.Lock()

    def read(self, namespace: str, name: str):
        with self._lock:
            entry = self._data.get((namespace, name))
            if entry is None:
                return None, None
            spec, version = entry
            return json.loads(json.dumps(spec)), str(version)

    def write(self, namespace: str, name: str, spec: dict,
              expected_version: Optional[str]) -> bool:
        with self._lock:
            entry = self._data.get((namespace, name))
            if expected_version is None:
                if entry is not None:
                    return False
                self._data[(namespace, name)] = (spec, 1)
                return True
            if entry is None or str(entry[1]) != expected_version:
                return False
            self._data[(namespace, name)] = (spec, entry[1] + 1)
            return True


class KubectlLeases:
    """coordination.k8s.io/v1 Lease CAS via kubectl."""

    def __init__(self, kubectl: str = "kubectl"):
        self.kubectl = kubectl

    def _manifest(self, namespace: str, name: str, spec: dict,
                  version: Optional[str]) -> dict:
        meta: dict = {"name": name, "namespace": namespace}
        if version is not None:
            meta["resourceVersion"] = version
        return {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                "metadata": meta, "spec": spec}

    def read(self, namespace: str, name: str):
        proc = subprocess.run(
            [self.kubectl, "get", "lease", name, "-n", namespace,
             "-o", "json"],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            # "lease absent" and "API unreachable" must stay distinct: a
            # create attempt against a *present* lease during an API blip
            # would read as a lost election and depose a healthy leader
            if "notfound" in proc.stderr.lower().replace(" ", ""):
                return None, None
            raise RuntimeError(f"lease read failed: {proc.stderr.strip()}")
        obj = json.loads(proc.stdout)
        return obj.get("spec", {}), obj["metadata"].get("resourceVersion")

    # a genuine lost CAS race surfaces as kubectl's structured status
    # reason — "Error from server (Conflict): ..." / "(AlreadyExists)".
    # Match that token, not free-text substrings: an unrelated API error
    # whose message merely *contains* "conflict" must raise (transient
    # failure), not read as an authoritative loss that deposes a leader
    # still holding a valid lease.
    _CAS_REASON = re.compile(
        r"error from server \((conflict|alreadyexists)\)", re.IGNORECASE)

    def write(self, namespace: str, name: str, spec: dict,
              expected_version: Optional[str]) -> bool:
        verb = ["create"] if expected_version is None else ["replace"]
        manifest = self._manifest(namespace, name, spec, expected_version)
        proc = subprocess.run(
            [self.kubectl, *verb, "-f", "-"],
            input=json.dumps(manifest), capture_output=True, text=True,
        )
        if proc.returncode != 0:
            err = proc.stderr.strip()
            if self._CAS_REASON.search(err):
                logger.debug("lease write lost the CAS race: %s", err)
                return False
            raise RuntimeError(f"lease write failed: {err}")
        return True


class LeaderElector:
    """Acquire-then-renew loop around a CAS lease.

    ``run(stop, lead)`` blocks until leadership is won, calls ``lead``
    (which should run the control loop until ``stop``), and — if renewal
    is ever lost — sets ``stop`` so the caller exits and a restart
    rejoins the election as a follower. One elector per process.
    """

    def __init__(self, client: LeaseClient, identity: str,
                 name: str = "dynamo-tpu-operator",
                 namespace: str = "default",
                 lease_duration_s: float = 15.0,
                 renew_interval_s: float = 5.0,
                 renew_deadline_s: Optional[float] = None,
                 clock=time.monotonic):
        self.client = client
        self.identity = identity
        self.name = name
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_interval_s = renew_interval_s
        # how long renewal may keep FAILING (API unreachable) before the
        # leader steps down — must undercut lease_duration_s, or a
        # follower takes the expired lease while we still reconcile
        # (split brain). controller-runtime's RenewDeadline analog.
        self.renew_deadline_s = (
            renew_deadline_s if renew_deadline_s is not None
            else lease_duration_s * 2 / 3
        )
        self._clock = clock
        # (holder, renewTime) we last saw → local time we saw it
        self._observed: Optional[Tuple[tuple, float]] = None
        self._last_renew_written: Optional[datetime] = None

    def _spec(self, transitions: int) -> dict:
        # renewTime must be a valid MicroTime (the apiserver rejects
        # anything else), but observers only time its *changes* with
        # their own clocks (see module docstring) — so it just has to be
        # well-formed and distinct per renewal, never compared to a
        # remote clock. Strictly-increasing guard: a same-microsecond
        # (or backwards-stepping) wall clock would otherwise make a
        # renewal look like no renewal.
        now = datetime.now(timezone.utc)
        if self._last_renew_written is not None and now <= self._last_renew_written:
            now = self._last_renew_written + timedelta(microseconds=1)
        self._last_renew_written = now
        stamp = now.strftime("%Y-%m-%dT%H:%M:%S.%fZ")
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration_s),
            "leaseTransitions": transitions,
            "renewTime": stamp,
        }

    def try_acquire_or_renew(self) -> bool:
        """One CAS round-trip. True = we hold the lease now."""
        spec, version = self.client.read(self.namespace, self.name)
        now = self._clock()
        if spec is None:
            return self.client.write(
                self.namespace, self.name, self._spec(0), None)
        holder = spec.get("holderIdentity")
        fingerprint = (holder, spec.get("renewTime"))
        if holder == self.identity:
            return self.client.write(
                self.namespace, self.name,
                self._spec(spec.get("leaseTransitions", 0)),
                version)
        if self._observed is None or self._observed[0] != fingerprint:
            self._observed = (fingerprint, now)  # holder is alive; restart TTL
            return False
        if now - self._observed[1] < spec.get(
                "leaseDurationSeconds", self.lease_duration_s):
            return False
        # holder stopped renewing a full lease ago: take over
        took = self.client.write(
            self.namespace, self.name,
            self._spec(spec.get("leaseTransitions", 0) + 1), version)
        if took:
            logger.info("leader election: %s took over from expired %s",
                        self.identity, holder)
        return took

    def run(self, stop: threading.Event, lead) -> None:
        while not stop.is_set():
            try:
                acquired = self.try_acquire_or_renew()
            except Exception:
                # API blip while campaigning: stay a follower and retry
                logger.exception("lease acquire attempt failed")
                acquired = False
            if acquired:
                logger.info("leader election: %s is leader", self.identity)
                renewer = threading.Thread(
                    target=self._renew_until_lost, args=(stop,), daemon=True)
                renewer.start()
                try:
                    lead()
                finally:
                    stop.set()
                    renewer.join(timeout=self.renew_interval_s * 2)
                return
            stop.wait(self.renew_interval_s)

    def _renew_until_lost(self, stop: threading.Event) -> None:
        last_renewed = self._clock()
        while not stop.wait(self.renew_interval_s):
            try:
                if not self.try_acquire_or_renew():
                    # authoritative: someone else won the CAS
                    logger.error("leader election: %s lost the lease; "
                                 "stepping down", self.identity)
                    stop.set()
                    return
                last_renewed = self._clock()
            except Exception:
                # transient API failure: retry, but only inside the renew
                # deadline — past it a follower may legitimately take the
                # expired lease, so leading on is a split brain
                logger.exception("lease renewal attempt failed")
                if self._clock() - last_renewed > self.renew_deadline_s:
                    logger.error(
                        "leader election: %s could not renew within "
                        "%.0fs; stepping down", self.identity,
                        self.renew_deadline_s)
                    stop.set()
                    return
