"""Seeded LGB010 violation — a tensor read on the selector thread.  This
file is ONLY an analysis-pass fixture; nothing imports it."""

import selectors


class Gateway:
    def __init__(self):
        self._sel = selectors.DefaultSelector()

    def close(self):
        self._sel.close()

    def _loop(self):
        while True:
            for key, _ in self._sel.select(timeout=0.25):
                self._finish(key.data)

    def _finish(self, score):
        # BAD: .item() waits for the card's queue on the event loop
        return score.item()
