"""Asynchronous frame writer: take binio writes off the driver's
critical path (counterpart of swraytracing_tpu/io/asyncwriter.py).

The reference writes every frame synchronously inside its time loop
(qgsw_raytrace.m:153-172) — irrelevant at 50 packets, but at the
production scale (1e6 packets, ~16 MB per packet frame, 10 frames per
chunk) synchronous writes serialize disk I/O with device compute. The
drivers enqueue (fn, args) onto a single worker thread instead: frame
order per file is preserved (one worker, FIFO), the GIL is released
inside numpy's file writes so the main thread keeps launching device work,
and exceptions surface on the next submit or at close().

Frame addressing makes this safe: every write carries its absolute
frame index (binio.write_field seeks), so nothing depends on write
timing — only on per-file ordering, which the FIFO guarantees.
"""

from __future__ import annotations

import queue
import threading

__all__ = ["AsyncWriter"]


class AsyncWriter:
    """Single-worker FIFO writer. Use as a context manager:

        with AsyncWriter() as w:
            w.submit(binio.write_field, arr, path, frame)
        # close() joins and re-raises the first worker exception
    """

    _SENTINEL = object()

    def __init__(self, maxsize: int = 32):
        # bounded queue: backpressure instead of unbounded host-memory
        # growth if the disk cannot keep up with the device
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is self._SENTINEL:
                    return
                if self._exc is None:
                    fn, args, kwargs = item
                    fn(*args, **kwargs)
            except BaseException as e:  # propagate to the submitter
                self._exc = e
            finally:
                self._q.task_done()

    def _check(self):
        # STICKY: once a write failed, every later submit/flush/close
        # raises. Clearing the error and continuing would leave a
        # silent hole in the frame files (writes queued after the
        # failure are skipped by the worker; frame-addressed files
        # would then carry stale bytes at the skipped offsets while
        # later frames landed).
        if self._exc is not None:
            raise self._exc

    def submit(self, fn, *args, **kwargs):
        """Enqueue fn(*args, **kwargs). Arguments must be safe to use
        from the worker thread — pass materialized numpy arrays, not
        views of buffers the caller will mutate."""
        self._check()
        self._q.put((fn, args, kwargs))

    def flush(self):
        """Block until every enqueued write has completed."""
        self._q.join()
        self._check()

    def close(self):
        self._q.put(self._SENTINEL)
        self._thread.join()
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False
