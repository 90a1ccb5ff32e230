"""Background batch-assembly pipeline (port of muzero_general_tpu/prefetch.py).

The reference trainer prefetches the next batch from the ReplayBuffer actor
while the current one trains (reference trainer.py:66-72 — a one-deep
pipeline between two processes). Single-process counterpart: a daemon thread
assembles batches (C++ assembler releases the GIL) while the device runs the
train step AND while the self-play chunk executes, so host assembly time is
hidden behind device time. ReplayBuffer methods are lock-serialized
(replay.ReplayBuffer.lock), so the only semantic delta is bounded staleness —
a prefetched batch may predate the newest saved game or priority write-back
by at most `depth` batches, far tighter than the reference's free-running
actors.
"""

import queue
import threading


class BatchPrefetcher:
    def __init__(self, replay, depth: int = 8):
        self.replay = replay
        self.depth = depth
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._started = False
        self._error = None

    def _producer(self):
        try:
            while not self._stop.is_set():
                if not self.replay.buffer:
                    self._stop.wait(0.005)
                    continue
                item = self.replay.get_batch()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # handed to take(), which raises it
            self._error = e

    def take(self, n: int):
        """Blocking: n (index_batch, batch) pairs, freshest the producer has.
        Raises what stopped the producer, once its queued batches are taken."""
        if not self._started:
            self._thread.start()
            self._started = True
        items = []
        while len(items) < n:
            try:
                items.append(self._q.get(timeout=0.05))
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("the batch prefetcher's producer failed") from self._error
        return items

    def stop(self):
        self._stop.set()
        if self._started:
            # Drain so a blocked put() observes the stop flag.
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
