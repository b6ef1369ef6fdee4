"""Seeded fault: a raise injected between the alloc and the page-table
commit — the exact exception-window leak the lifecycle suite exists to
catch (and the shape `attach_stream` guards with its broad handler)."""


class Engine:
    def __init__(self, allocator):
        self.allocator = allocator
        self._table = {}

    def attach(self, slot, rid, need):
        pages = self.allocator.alloc(need, rid)  # line 12: THE leak line
        if slot in self._table:
            raise RuntimeError("slot busy")  # line 14: the injected fault
        self._table[slot] = pages
        return pages
