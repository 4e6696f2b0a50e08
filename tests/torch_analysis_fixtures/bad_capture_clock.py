"""Seeded LGB005 violation — a wall clock inside a pass that a CUDA graph
captures: replays repeat only the device work, so the clock is read once,
at capture.  This file is ONLY an analysis-pass fixture; nothing imports
it."""

import time

from lightgbm_tpu_torch import native


class Learner:
    def _capture(self, fn):
        graph = object()
        return native.capture(graph, fn, None, "relaxed")

    def _queue(self, key, fn):
        return self._capture(fn)

    def grow(self, st):
        t0 = time.perf_counter()            # fine: the eager driver
        self._queue(("step",), lambda: self._step(st))
        return time.perf_counter() - t0

    def _step(self, st):
        # BAD: captured: the same timestamp on every replay
        st.stamp = time.perf_counter()
