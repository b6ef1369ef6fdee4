"""Lifecycle suppression: inline markers silence exactly the named rule."""
import threading


class Worker:
    def __init__(self):
        self._lock = threading.Lock()

    def silenced(self, job):
        self._lock.acquire()  # torchlint: disable=L4 — handoff documented
        handle(job)
        self._lock.release()

    def still_fires(self, job):
        self._lock.acquire()  # line 15: no marker, must fire
        handle(job)
        self._lock.release()
