"""Inline ``# torchlint: disable=`` works for the concurrency suite too."""
import threading


class P:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def start(self):
        threading.Thread(target=self._run, daemon=True).start()

    def bump(self):
        with self._lock:
            self._n += 1

    def read(self):
        with self._lock:
            return self._n

    def _run(self):
        # reset precedes any reader by construction
        # torchlint: disable=T1
        self._n = 0
        if self._n > 3:  # line 25: NOT suppressed — must still fire
            return
