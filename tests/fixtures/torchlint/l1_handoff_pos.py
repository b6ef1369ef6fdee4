"""L1 handoff positives: staged custody and handoff connections that
can leak out of the function."""
import socket

from pdnlp_tpu_torch.serve.handoff import HandoffChannel
from pdnlp_tpu_torch.serve.kvpage import stage_handoff


class Sender:
    def __init__(self, allocator, channel):
        self.allocator = allocator
        self.channel = channel

    def leak_staged_on_dispatch_raise(self, pages, rid, meta, k, v):
        staged = stage_handoff(self.allocator, pages, rid)  # 15: send raises
        self.channel.send(meta, k, v)
        self.allocator.release_owner(staged)

    def leak_staged_on_early_return(self, pages, rid, dead):
        staged = stage_handoff(self.allocator, pages, rid)  # 20: bare return
        if dead:
            return None
        self.allocator.release_owner(staged)
        return staged


def leak_channel(address, meta, k, v):
    ch = HandoffChannel(address)  # line 28: send raises before close
    ch.send(meta, k, v)
    ch.close()


def leak_socket(address):
    sock = socket.create_connection(address)  # line 34: handshake raises
    handshake(sock)
    sock.close()
