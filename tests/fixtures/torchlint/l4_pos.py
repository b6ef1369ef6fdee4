"""L4 positives: manual lock acquires without release on every path."""
import threading


class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self.jobs = []

    def leak_on_exception(self, job):
        self._lock.acquire()  # line 11: handle raises before release
        handle(job)
        self._lock.release()

    def leak_on_early_return(self, job):
        self._lock.acquire()  # line 16: bare return path
        if not job:
            return None
        self.jobs.append(job)
        self._lock.release()
        return job


def helper_with_lock_param(lock, items):
    lock.acquire()  # line 25: process raises before release
    process(items)
    lock.release()
