"""Virtual time for the fleet simulator (the port's copy of
``dynamo_tpu/sim/clock.py``).

The control plane already takes an injectable ``clock`` everywhere, but
its waiting primitives are asyncio timers (``asyncio.sleep`` in the pool
poll loop and respawn backoff, ``asyncio.wait_for`` on the admission
queue). To run those at 1000x real time without forking any logic, the
sim installs an event loop whose ``time()`` is a :class:`VirtualClock`
and whose iteration advances that clock by the pending-timer deadline
whenever nothing is ready to run — the textbook discrete-event skip.
Real file descriptors still work (they are polled with a zero timeout),
so the loop degrades gracefully if a scenario ever touches sockets.

Nothing in this module (or anywhere under ``sim/``) reads the wall
clock; determinism tests pin that.
"""

from __future__ import annotations

import asyncio
import contextvars
import gc
import heapq
import selectors
from asyncio import events, format_helpers
from typing import Awaitable, Callable, List, Optional, TypeVar

T = TypeVar("T")

# When the loop blocks with no timers at all (timeout=None) the virtual
# clock cannot know how far to skip; advance in coarse fixed steps so a
# stray wait still terminates instead of spinning at +0.
_IDLE_STEP_S = 1.0

# Hard ceiling on total virtual seconds a single run may advance; a
# scenario that sleeps past this is wedged, not slow.
MAX_VIRTUAL_S = 10_000_000.0

# asyncio's own constants (base_events.py): the longest select wait, and
# when a heap with many cancelled timers is rebuilt instead of popped
_MAX_SELECT_S = 24 * 3600
_MIN_SCHEDULED = 100
_MIN_CANCELLED_FRACTION = 0.5


class VirtualClock:
    """A monotonically advancing virtual timebase.

    Instances are callables returning virtual seconds, matching the
    ``clock: Callable[[], float]`` parameter every control-plane class
    accepts (``SlaPolicy``, ``AdmissionController``, ``PoolManager``,
    ``KvScheduler``, ``SloTracker``, ``TenantQuotas``...).
    """

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        if dt > 0.0:
            self._now += dt
        if self._now > MAX_VIRTUAL_S:
            raise RuntimeError(
                f"virtual clock ran past {MAX_VIRTUAL_S:.0f}s — "
                "scenario is not terminating"
            )


# The loop polls real file descriptors (the self-pipe that signal
# wakeups and call_soon_threadsafe write to, and the sockets of a rare
# scenario that touches them) without blocking, every this many
# iterations and on every iteration that finds nothing to run: an OS
# poll costs more than the virtual hop itself.
_POLL_EVERY = 16

# the cyclic collector's first threshold while a run lasts (run_virtual)
_GC_GEN0 = 20_000


class _Handle(events.Handle):
    """``asyncio.Handle`` without the debug probe in its constructor (the
    loop builds these only when it is not in debug mode)."""

    __slots__ = ()

    def __init__(self, callback, args, loop, context) -> None:
        self._context = (context if context is not None
                         else contextvars.copy_context())
        self._loop = loop
        self._callback = callback
        self._args = args
        self._cancelled = False
        self._repr = None
        self._source_traceback = None


class _TimerHandle(events.TimerHandle):
    """``asyncio.TimerHandle`` built the same lean way."""

    __slots__ = ()

    def __init__(self, when, callback, args, loop, context) -> None:
        self._context = (context if context is not None
                         else contextvars.copy_context())
        self._loop = loop
        self._callback = callback
        self._args = args
        self._cancelled = False
        self._repr = None
        self._source_traceback = None
        self._when = when
        self._scheduled = False


class VirtualTimeEventLoop(asyncio.SelectorEventLoop):
    """A selector event loop whose ``time()`` is virtual.

    ``call_later`` / ``asyncio.sleep`` / ``asyncio.wait_for`` schedule
    against :meth:`time`, and each iteration advances the clock to
    the earliest deadline whenever nothing else is runnable, so timer
    waits complete in microseconds of wall time regardless of their
    virtual duration.

    Outside debug mode the loop keeps asyncio's schedule exactly (the
    ready queue in FIFO order, due timers appended after it, one batch
    an iteration) and spends less host time on it: its timer heap holds
    ``(when, handle)`` pairs, which order exactly as the handles do
    (``TimerHandle`` compares by ``when`` alone) but compare in C, and
    callbacks run without a frame of ``Handle._run`` each. A simulated
    run does little but schedule and run callbacks, so the loop's own
    share of its host time matters.
    """

    def __init__(self, clock: VirtualClock) -> None:
        super().__init__(selector=selectors.DefaultSelector())
        self.virtual_clock = clock
        self._spins = 0

    def time(self) -> float:
        return self.virtual_clock._now

    def call_soon(self, callback, *args, context=None):
        if self._debug:
            return super().call_soon(callback, *args, context=context)
        self._check_closed()
        handle = _Handle(callback, args, self, context)
        self._ready.append(handle)
        return handle

    def call_later(self, delay, callback, *args, context=None):
        if delay is None:
            raise TypeError("delay must not be None")
        return self.call_at(self.virtual_clock._now + delay, callback,
                            *args, context=context)

    def call_at(self, when, callback, *args, context=None):
        if when is None:
            raise TypeError("when cannot be None")
        self._check_closed()
        if self._debug:
            self._check_thread()
            self._check_callback(callback, "call_at")
            timer = events.TimerHandle(when, callback, args, self, context)
            if timer._source_traceback:
                del timer._source_traceback[-1]
        else:
            timer = _TimerHandle(when, callback, args, self, context)
        heapq.heappush(self._scheduled, (when, timer))
        timer._scheduled = True
        return timer

    def _run_once(self) -> None:
        # asyncio's BaseEventLoop._run_once over (when, handle) pairs
        scheduled = self._scheduled
        n = len(scheduled)
        if (n > _MIN_SCHEDULED
                and self._timer_cancelled_count / n > _MIN_CANCELLED_FRACTION):
            kept = []
            for entry in scheduled:
                if entry[1]._cancelled:
                    entry[1]._scheduled = False
                else:
                    kept.append(entry)
            heapq.heapify(kept)
            self._scheduled = scheduled = kept
            self._timer_cancelled_count = 0
        else:
            while scheduled and scheduled[0][1]._cancelled:
                self._timer_cancelled_count -= 1
                heapq.heappop(scheduled)[1]._scheduled = False

        ready = self._ready
        clock = self.virtual_clock
        timeout = None
        if ready or self._stopping:
            timeout = 0
        elif scheduled:
            timeout = scheduled[0][0] - clock._now
            if timeout < 0:
                timeout = 0
            elif timeout > _MAX_SELECT_S:
                timeout = _MAX_SELECT_S
        # the time warp: poll real FDs without blocking, then turn the
        # wait asyncio asked for into a jump of the virtual clock
        self._spins += 1
        event_list = None
        if timeout is None or self._spins >= _POLL_EVERY:
            self._spins = 0
            event_list = self._selector.select(0)
        if event_list:
            self._process_events(event_list)
            event_list = None
        elif timeout != 0:
            clock.advance(_IDLE_STEP_S if timeout is None else timeout)

        end_time = clock._now + self._clock_resolution
        while scheduled and scheduled[0][0] < end_time:
            handle = heapq.heappop(scheduled)[1]
            handle._scheduled = False
            ready.append(handle)

        debug = self._debug
        for _ in range(len(ready)):
            handle = ready.popleft()
            if handle._cancelled:
                continue
            if debug:
                self._current_handle = handle
                try:
                    handle._run()
                finally:
                    self._current_handle = None
                continue
            try:
                handle._context.run(handle._callback, *handle._args)
            except (SystemExit, KeyboardInterrupt):
                raise
            except BaseException as exc:
                self._callback_failed(handle, exc)
        handle = None  # breaks a cycle when a callback raised

    def _callback_failed(self, handle, exc: BaseException) -> None:
        # what Handle._run reports for a callback that raised
        cb = format_helpers._format_callback_source(
            handle._callback, handle._args)
        context = {"message": f"Exception in callback {cb}",
                   "exception": exc, "handle": handle}
        if handle._source_traceback:
            context["source_traceback"] = handle._source_traceback
        self.call_exception_handler(context)


def run_virtual(
    main: Callable[[], Awaitable[T]],
    clock: Optional[VirtualClock] = None,
) -> T:
    """Run ``main()`` to completion on a fresh virtual-time loop.

    Mirrors ``asyncio.run``: owns the loop for the duration, cancels
    leftover tasks, and closes the loop. Returns the coroutine result.

    While it runs, the cyclic collector's youngest generation waits for
    ``_GC_GEN0`` new objects instead of the default 700: a run allocates
    a handle, a future or a record for every event, nearly all of them
    short-lived, and scanning them every 700 costs a twentieth of a
    run's host time. The process's thresholds are restored after.
    """
    clock = clock if clock is not None else VirtualClock()
    loop = VirtualTimeEventLoop(clock)
    thresholds = gc.get_threshold()
    gc.set_threshold(max(thresholds[0], _GC_GEN0), *thresholds[1:])
    try:
        asyncio.set_event_loop(loop)
        return loop.run_until_complete(main())
    finally:
        try:
            _cancel_pending(loop)
        finally:
            asyncio.set_event_loop(None)
            loop.close()
            gc.set_threshold(*thresholds)


def _cancel_pending(loop: asyncio.AbstractEventLoop) -> None:
    pending: List[asyncio.Task] = [
        t for t in asyncio.all_tasks(loop) if not t.done()
    ]
    for task in pending:
        task.cancel()
    if pending:
        loop.run_until_complete(
            asyncio.gather(*pending, return_exceptions=True)
        )
