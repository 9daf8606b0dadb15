"""Fault injection: make a transfer fail or a pull stall on demand.

The port's copy of ``dynamo_tpu/utils/faults.py``. ``DYN_FAULT`` names
injection *sites* compiled into the paths they sabotage::

    DYN_FAULT=child_exit:once                   # the engine child dies
    DYN_FAULT=decode_burst_hang:once            # wedge the next decode sync
    DYN_FAULT=transfer_conn_drop:once           # drop the next pull serve
    DYN_FAULT=prefix_pull_stall:0.1             # stall 10% of prefix pulls

Spec grammar: ``site:once`` fires exactly once, ``site:<float>`` fires
with that probability per evaluation, ``site:off`` disarms. Tests arm
sites programmatically with ``arm()`` (no env mutation) and release hung
sites with ``release()``.

Sites wired in the port:

- ``child_exit`` — a supervised engine child (``llm/engines/
  subprocess_host.py``) exits hard (``os._exit``) as a request arrives:
  the host must fail the stream and respawn.
- ``decode_burst_hang`` — the scheduler's decode host sync blocks (in its
  executor thread) until ``release()``: the shape of a dead device, and
  the wedge the stall watchdog's ``decode_stall`` trip exists to catch.
- ``transfer_conn_drop`` — the pull-SERVING side of the cluster KV fabric
  dies mid-serve (``disagg/transfer.py``): the puller must fall back to a
  local recompute with nothing registered.
- ``prefix_pull_stall`` — a prefix pull (``kv/fabric.py``) stalls
  mid-flight instead of dying: the scheduler's pull deadline must cancel
  it and fall back to a local recompute, byte-identically, with zero
  leaked blocks on either side.

Every fire is recorded in the flight ring (``fault.injected``), logged
(WARNING) and counted in ``fired_total``, so a chaos run's artifact shows
which failures were synthetic.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)

FAULT_ENV = "DYN_FAULT"

_lock = threading.Lock()
# site → spec: "once" (not yet fired) | float probability. Absent = off.
_armed: Dict[str, object] = {}
_env_loaded = False
# sites that hung and await release; created lazily per site
_hang_events: Dict[str, threading.Event] = {}
fired_total: Dict[str, int] = {}


def _load_env_locked() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    raw = os.environ.get(FAULT_ENV, "")
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, spec = part.partition(":")
        try:
            _arm_locked(site.strip(), spec.strip() or "once")
        except ValueError as e:
            # a typo'd fault spec must never take the server down: the
            # operator is injecting faults on purpose, loudly
            logger.error("ignoring malformed %s entry %r: %s",
                         FAULT_ENV, part, e)


def _arm_locked(site: str, spec: str) -> None:
    if not site:
        raise ValueError("empty fault site")
    if spec == "off":
        _armed.pop(site, None)
        return
    if spec == "once":
        _armed[site] = "once"
        return
    p = float(spec)  # raises ValueError on garbage
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"probability {p} outside [0, 1]")
    _armed[site] = p


def arm(site: str, spec: str = "once") -> None:
    """Programmatically arm a site (tests; same grammar as DYN_FAULT)."""
    with _lock:
        _load_env_locked()
        _arm_locked(site, spec)


def reset() -> None:
    """Disarm everything and forget the env parse (tests)."""
    global _env_loaded
    with _lock:
        _armed.clear()
        fired_total.clear()
        _env_loaded = False
        for ev in _hang_events.values():
            ev.set()
        _hang_events.clear()


def fire(site: str) -> bool:
    """Should this evaluation of ``site`` fail? Consumes ``once`` arms.

    Thread-safe and cheap when nothing is armed (one dict lookup under a
    lock): safe to call from executor threads and hot loops alike."""
    with _lock:
        _load_env_locked()
        spec = _armed.get(site)
        if spec is None:
            return False
        if spec == "once":
            del _armed[site]
        elif random.random() >= spec:
            return False
        fired_total[site] = fired_total.get(site, 0) + 1
    from ..telemetry.flight import flight_recorder

    flight_recorder().record("fault.injected", site=site)
    logger.warning("FAULT INJECTED [%s]", site)
    return True


def maybe_hang(site: str, timeout_s: float = 600.0) -> bool:
    """If ``site`` fires, BLOCK the calling thread until ``release()`` (or
    the safety timeout). Call from the thread being sabotaged, never the
    event loop. Returns whether it hung."""
    if not fire(site):
        return False
    with _lock:
        ev = _hang_events.setdefault(site, threading.Event())
    ev.wait(timeout_s)
    return True


def release(site: Optional[str] = None) -> None:
    """Un-wedge hung sites (all of them when ``site`` is None)."""
    with _lock:
        events = [e for s, e in _hang_events.items() if site in (None, s)]
    for ev in events:
        ev.set()
