"""L4 negatives: with-managed, try/finally, and conditional acquires."""
import threading


class Worker:
    def __init__(self):
        self._lock = threading.Lock()

    def with_managed(self, job):
        with self._lock:
            return handle(job)

    def try_finally(self, job):
        self._lock.acquire()
        try:
            return handle(job)
        finally:
            self._lock.release()

    def conditional_acquire(self, job):
        if self._lock.acquire(timeout=0.1):  # out of scope by design
            handle(job)
            self._lock.release()

    def straight_line(self):
        self._lock.acquire()
        self.count = 1
        self._lock.release()
