"""Graceful preemption (the port's copy of ``climb_tpu/utils/preemption.py``).

Schedulers deliver SIGTERM with a short grace window before eviction. With
the elastic train state on, the trainer polls ``preemption_requested()`` at
every step boundary and, on a pending signal, saves the full train state
(parameters, AdamW moments, update count, the dropout generator, Python's
``random`` state and the loader position) and exits with status 143; the next
run of the same command resumes mid-epoch on a bit-identical trajectory
(``tests/test_torch_preemption.py``).

The handler only sets a flag: every checkpoint write happens on the main
thread at a step boundary, never inside the signal handler.
"""

import logging
import signal
import threading

logger = logging.getLogger(__name__)

_FLAG = threading.Event()
# a stack of {signal: previous handler} maps, one per active install. The
# handlers are scoped to a train loop (installed at entry, uninstalled in a
# finally), never left behind process-wide: a leaked flag-only handler makes
# the process silently deaf to SIGTERM once the loop has ended (a pytest run
# that had driven a trainer in-process outlived its `timeout ...` wrapper,
# whose SIGTERM only set this flag, which nothing polled any more).
_PREV = []


def install_preemption_handler(signals=(signal.SIGTERM,)) -> bool:
    """Install flag-setting handlers, keeping the previous ones for
    ``uninstall_preemption_handler``. Returns False outside the main thread
    (the signal module's rule). Nested installs stack."""

    def _handler(signum, frame):
        logger.warning("Received signal %d: will checkpoint and exit at the next step "
                       "boundary", signum)
        _FLAG.set()

    saved = {s: signal.getsignal(s) for s in signals}
    try:
        for s in signals:
            signal.signal(s, _handler)
    except ValueError:  # not in the main thread
        return False
    _PREV.append(saved)
    return True


def uninstall_preemption_handler() -> None:
    """Restore the handlers kept by the matching install.

    A pending request that nothing acted on survives the uninstall on
    purpose: a SIGTERM that lands after the loop's last poll (during the
    end-of-task eval or the checkpoint save) must not be dropped, and the
    multi-task driver polls ``preemption_requested()`` between tasks and
    exits 143. A request that was acted on clears the flag where it exits,
    so a later train loop in the same process is not preempted by it.
    """
    if _PREV:
        for s, h in _PREV.pop().items():
            if h is None:
                # the handler found at install time was installed from C and
                # cannot be put back from Python; SIG_DFL is the nearest safe one
                h = signal.SIG_DFL
            try:
                signal.signal(s, h)
            except (ValueError, TypeError, OSError):
                pass
    if not _PREV and _FLAG.is_set():
        logger.warning("Preemption was requested but not acted on yet; the request stays "
                       "pending for the caller")


def preemption_requested() -> bool:
    return _FLAG.is_set()


def request_preemption():
    """Trigger from code (tests, a cooperative shutdown)."""
    _FLAG.set()


def clear_preemption():
    _FLAG.clear()
