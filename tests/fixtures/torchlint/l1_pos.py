"""L1 positives: acquired resources that can leak out of the function."""
import shutil
import tempfile
import threading


class Engine:
    def __init__(self):
        self.allocator = PageAllocator(64, 16)
        self._sem = threading.Semaphore(4)
        self._table = {}

    def leak_on_exception(self, slot, rid, need):
        pages = self.allocator.alloc(need, rid)  # line 14: validate raises
        validate(slot)
        self._table[slot] = pages

    def leak_on_early_return(self, rid, need):
        held = self.allocator.alloc(need, rid)  # line 19: bare return path
        if need > 8:
            return None
        self.allocator.release(held, rid)
        return held

    def leak_shared_pin(self, pins, rid):
        self.allocator.share(pins, rid)  # line 26: verify raises
        verify(pins)
        self.allocator.release(pins, rid)

    def leak_semaphore(self, job):
        self._sem.acquire()  # line 31: run raises before release
        run(job)
        self._sem.release()

    def _reserve(self, rid, need):
        return self.allocator.alloc(need, rid)  # clean: caller inherits

    def leak_via_helper(self, rid, need):
        pages = self._reserve(rid, need)  # line 39: inherited obligation
        inspect(pages)
        self.allocator.release(pages, rid)


def leak_tmpdir(prefix):
    workdir = tempfile.mkdtemp(prefix=prefix)  # line 45: stage raises
    stage(workdir)
    shutil.rmtree(workdir)


def leak_standby(router, idx):
    router.deactivate_replica(idx)  # line 51: rebalance raises (exc_only)
    rebalance(router)
    router.activate_replica(idx)
