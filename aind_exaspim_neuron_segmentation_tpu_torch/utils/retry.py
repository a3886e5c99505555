"""Retry with exponential backoff for flaky cloud IO.

The reference has no retry logic anywhere, including around GCS/S3
reads (SURVEY.md section 5 "failure detection: none"); large-volume
streaming inference makes transient cloud errors routine, so the store
layer wraps remote gets with this.
"""

import logging
import time

LOG = logging.getLogger(__name__)

TRANSIENT_EXCEPTIONS = (ConnectionError, TimeoutError, OSError)
# OSError covers flaky-network errnos, but these subclasses are normal
# control flow (a zarr store legitimately omits fill-value chunks):
# retrying them would cost attempts x backoff per missing chunk.
NON_TRANSIENT_EXCEPTIONS = (
    FileNotFoundError, IsADirectoryError, NotADirectoryError,
    PermissionError,
)


def retry(fn, *args, attempts=4, base_delay=0.5, max_delay=8.0,
          transient=TRANSIENT_EXCEPTIONS,
          non_transient=NON_TRANSIENT_EXCEPTIONS, **kwargs):
    """Call ``fn``; on a transient exception back off and retry.

    Delays: base_delay * 2^k capped at max_delay. The final attempt's
    exception propagates; ``non_transient`` exceptions propagate
    immediately even if they subclass a transient type.
    """
    delay = base_delay
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except non_transient:
            raise
        except transient as err:
            if attempt == attempts - 1:
                raise
            LOG.warning(
                "transient IO error (%s), retry %d/%d in %.1fs",
                err, attempt + 1, attempts - 1, delay,
            )
            time.sleep(delay)
            delay = min(delay * 2, max_delay)


def retrying(attempts=4, base_delay=0.5, max_delay=8.0,
             transient=TRANSIENT_EXCEPTIONS):
    """Decorator form of :func:`retry`."""

    def wrap(fn):
        def inner(*args, **kwargs):
            return retry(
                fn, *args, attempts=attempts, base_delay=base_delay,
                max_delay=max_delay, transient=transient, **kwargs,
            )

        inner.__name__ = getattr(fn, "__name__", "retrying")
        return inner

    return wrap
