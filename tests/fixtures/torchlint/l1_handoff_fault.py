"""Seeded fault: a raise injected between the custody staging and the
dispatch-side release — the exact exception window
``PrefillWorker._dispatch_all`` closes with its finally (one discharge
point per handoff, success or failure)."""
from pdnlp_tpu_torch.serve.kvpage import stage_handoff


class Dispatcher:
    def __init__(self, allocator, channel):
        self.allocator = allocator
        self.channel = channel
        self.dead = False

    def dispatch(self, pages, rid, meta, k, v):
        staged = stage_handoff(self.allocator, pages, rid)  # 15: THE leak
        if self.dead:
            raise RuntimeError("decode pool dead")  # 17: injected fault
        self.channel.send(meta, k, v)
        self.allocator.release_owner(staged)
