"""L1 handoff negatives: every staged custody / connection acquired is
discharged on every path."""
import socket

from pdnlp_tpu_torch.serve.handoff import HandoffChannel
from pdnlp_tpu_torch.serve.kvpage import stage_handoff


class Sender:
    def __init__(self, allocator, channel):
        self.allocator = allocator
        self.channel = channel
        self._channels = {}

    def one_discharge_point(self, pages, rid, meta, k, v):
        # the _dispatch_all shape: success or failure, the staged owner
        # is released exactly once, in the finally
        staged = stage_handoff(self.allocator, pages, rid)
        try:
            self.channel.send(meta, k, v)
        finally:
            self.allocator.release_owner(staged)

    def begin_handoff_shape(self, pages, rid):
        # the acquire is the last act: the caller inherits the obligation
        return stage_handoff(self.allocator, pages, rid), pages

    def transfer_discharges_sender(self, pages, rid):
        # transfer is a RELEASER for the from-owner side; only the
        # stage_handoff wrapper (which returns the staged key) acquires
        self.allocator.transfer(pages, rid, rid + "#handoff")

    def channel_committed_at_birth(self, i, address):
        self._channels[i] = HandoffChannel(address)
        probe(i)


def channel_context(address, meta, k, v):
    with HandoffChannel(address) as ch:
        ch.send(meta, k, v)


def socket_try_finally(address):
    sock = socket.create_connection(address)
    try:
        handshake(sock)
    finally:
        sock.close()
