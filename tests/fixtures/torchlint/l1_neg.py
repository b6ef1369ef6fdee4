"""L1 negatives: every acquire is discharged on every path."""
import tempfile
import threading


class Engine:
    def __init__(self):
        self.allocator = PageAllocator(64, 16)
        self._sem = threading.Semaphore(4)
        self._table = {}
        self._lru = []

    def broad_handler(self, slot, rid, need):
        pages = self.allocator.alloc(need, rid)
        try:
            validate(slot)
            self._table[slot] = pages
        except BaseException:
            self.allocator.release_owner(rid)
            raise

    def try_finally(self, rid, need):
        pages = self.allocator.alloc(need, rid)
        try:
            work(pages)
        finally:
            self.allocator.release(pages, rid)

    def committed_before_raise(self, slot, rid, need):
        pages = self.allocator.alloc(need, rid)
        self._table[slot] = pages
        validate(slot)

    def committed_at_birth(self, rid):
        self._pages = self.allocator.alloc(4, rid)
        validate(rid)

    def store_mutator(self, rid, need):
        pages = self.allocator.alloc(need, rid)
        self._lru.append(pages)
        validate(rid)

    def returns_resource(self, rid, need):
        pages = self.allocator.alloc(need, rid)
        return pages

    def _dispose(self, pages, rid):
        self.allocator.release(pages, rid)

    def helper_releases(self, rid, need):
        pages = self.allocator.alloc(need, rid)
        self._dispose(pages, rid)

    def transfer_is_release(self, rid, need):
        pages = self.allocator.alloc(need, rid)
        self.allocator.transfer(pages, rid, "index")

    def pin_composed(self, slot, shared, src, rid):
        # the attach_stream shape: pin, alloc under a broad handler that
        # releases the owner, then commit the row into the page table
        pin = shared + [src]
        self.allocator.share(pin, rid)
        try:
            private = self.allocator.alloc(2, rid)
            row = shared + private
        except BaseException:
            self.allocator.release_owner(rid)
            raise
        self._table[slot] = row

    def sem_with(self, job):
        with self._sem:
            run(job)


def tmp_context():
    with tempfile.NamedTemporaryFile() as f:
        f.write(b"x")
