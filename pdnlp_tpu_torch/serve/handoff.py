"""KV handoff payloads and the length-prefixed loopback socket transport —
the twin of ``pdnlp_tpu/serve/handoff.py``, with the same wire format.

Disaggregated serving (prefill-role and decode-role engine pools) moves
one stream's KV pages between engines: in-process the exported payload
is handed straight to the importing batcher; across the socket transport
it crosses this module's stdlib-socket framing.

Wire format (one frame per handoff)::

    MAGIC(4) | body_len(4, big-endian) | body
    body = crc32(4) | header_len(4) | header JSON | K bytes | V bytes

The header carries the stream metadata (rid, pos, next token, page
count) plus the dtype name and shape of both payloads.  Every read is
exact-length: a connection that dies mid-frame, a truncated body, a
length prefix past the data or a checksum mismatch is a loud
:class:`HandoffError` — a torn payload is never imported.  After each
frame the receiver answers a 2-byte ack (``OK``/``ER``), so the sender
releases its staged custody exactly when the import landed.

Payloads here are CPU torch tensors (the port's ``export_pages`` returns
them): bf16 has no numpy dtype without ``ml_dtypes``, which the port
does not depend on.  :func:`encode_frame` takes torch tensors or numpy
arrays, :func:`decode_frame` returns torch tensors.  The dtype names in
the header are numpy's (``float32``, ``bfloat16``, ``int8``), which are
torch's names too, so a frame either package encodes decodes byte for
byte in the other.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: frame magic — rejects a stray connection (or an HTTP probe) loudly
MAGIC = b"PDKV"

#: per-frame acknowledgement bytes
ACK_OK = b"OK"
ACK_ERR = b"ER"

#: refuse absurd frames before allocating for them (a corrupt length
#: prefix must fail the frame, not OOM the receiver)
MAX_FRAME_BYTES = 1 << 31


class HandoffError(RuntimeError):
    """A handoff frame could not be sent, parsed, or acknowledged."""


#: header dtype names -> torch dtypes (numpy's names, which torch shares)
DTYPES = {name: getattr(torch, name) for name in (
    "float32", "float64", "float16", "bfloat16", "int8", "uint8", "int16",
    "int32", "int64")}


def _raw(x) -> Tuple[str, List[int], bytes]:
    """``(dtype name, shape, bytes)`` of a torch tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = str(t.dtype).replace("torch.", "")
        if name not in DTYPES:
            raise HandoffError(f"unsupported payload dtype {t.dtype}")
        return name, list(t.shape), t.reshape(-1).view(torch.uint8) \
            .numpy().tobytes()
    a = np.ascontiguousarray(x)
    return a.dtype.name, list(a.shape), a.tobytes()


# ------------------------------------------------------------- framing

def encode_frame(meta: Dict, payload_k, payload_v) -> bytes:
    """One handoff as a self-delimiting byte frame (see module doc)."""
    kname, kshape, kbytes = _raw(payload_k)
    vname, vshape, vbytes = _raw(payload_v)
    header = dict(meta)
    header["k"] = {"dtype": kname, "shape": kshape}
    header["v"] = {"dtype": vname, "shape": vshape}
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    tail = struct.pack(">I", len(hdr)) + hdr + kbytes + vbytes
    body = struct.pack(">I", zlib.crc32(tail)) + tail
    return MAGIC + struct.pack(">I", len(body)) + body


def decode_frame(frame: bytes) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """Parse one frame back into ``(meta, K, V)``.  Raises
    :class:`HandoffError` on any truncation, bad magic, checksum
    mismatch, or size that disagrees with the header's own shapes."""
    if len(frame) < 8 or frame[:4] != MAGIC:
        raise HandoffError("torn handoff payload: bad magic "
                           f"{frame[:4]!r} (not a KV handoff frame)")
    (body_len,) = struct.unpack(">I", frame[4:8])
    body = frame[8:]
    if len(body) != body_len:
        raise HandoffError(
            f"torn handoff payload: frame declares {body_len} body "
            f"bytes but carries {len(body)}")
    if body_len < 8:
        raise HandoffError("torn handoff payload: body too short for "
                           "checksum + header length")
    (crc,) = struct.unpack(">I", body[:4])
    tail = body[4:]
    if zlib.crc32(tail) != crc:
        raise HandoffError("torn handoff payload: checksum mismatch — "
                           "refusing to import corrupt KV pages")
    (hdr_len,) = struct.unpack(">I", tail[:4])
    if 4 + hdr_len > len(tail):
        raise HandoffError("torn handoff payload: header length "
                           "overruns the frame")
    meta = json.loads(tail[4:4 + hdr_len].decode("utf-8"))
    off = 4 + hdr_len
    arrays: List[torch.Tensor] = []
    for part in ("k", "v"):
        spec = meta.pop(part)
        dt = DTYPES.get(spec["dtype"])
        if dt is None:
            raise HandoffError(f"torn handoff payload: unknown dtype "
                               f"{spec['dtype']!r}")
        shape = tuple(int(s) for s in spec["shape"])
        itemsize = torch.empty((), dtype=dt).element_size()
        n = int(np.prod(shape)) * itemsize if shape else itemsize
        chunk = tail[off:off + n]
        if len(chunk) != n:
            raise HandoffError(
                f"torn handoff payload: {part.upper()} pages need {n} "
                f"bytes, frame holds {len(chunk)}")
        arrays.append(torch.frombuffer(bytearray(chunk), dtype=dt)
                      .reshape(shape) if n else torch.empty(shape, dtype=dt))
        off += n
    if off != len(tail):
        raise HandoffError(f"torn handoff payload: {len(tail) - off} "
                           "trailing bytes after the V pages")
    return meta, arrays[0], arrays[1]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise (EOF mid-frame = torn)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise HandoffError(
                f"torn handoff payload: connection closed {got}/{n} "
                "bytes into a frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket
               ) -> Optional[Tuple[Dict, torch.Tensor, torch.Tensor]]:
    """Read one frame off a socket; ``None`` on a CLEAN EOF between
    frames (peer closed the channel), :class:`HandoffError` on a tear
    anywhere inside one."""
    head = b""
    while len(head) < 8:
        chunk = sock.recv(8 - len(head))
        if not chunk:
            if head:
                raise HandoffError(
                    "torn handoff payload: connection closed inside "
                    "the frame prefix")
            return None
        head += chunk
    if head[:4] != MAGIC:
        raise HandoffError(f"torn handoff payload: bad magic "
                           f"{head[:4]!r} on the wire")
    (body_len,) = struct.unpack(">I", head[4:8])
    if body_len > MAX_FRAME_BYTES:
        raise HandoffError(f"torn handoff payload: implausible frame "
                           f"length {body_len}")
    return decode_frame(head + _recv_exact(sock, body_len))


# ----------------------------------------------------------- transport

class HandoffChannel:
    """Sender side of the RPC boundary: one connected socket, one frame
    per :meth:`send`, each awaited to its 2-byte ack.  Close it on every
    path."""

    def __init__(self, address: Tuple[str, int], timeout: float = 10.0):
        self._sock = socket.create_connection(address, timeout=timeout)
        self._lock = threading.Lock()

    def send(self, meta: Dict, payload_k, payload_v) -> None:
        """Ship one handoff and wait for the receiver's ack; raises
        :class:`HandoffError` when the peer refused the import or the
        connection tore."""
        frame = encode_frame(meta, payload_k, payload_v)
        with self._lock:
            try:
                self._sock.sendall(frame)
                ack = _recv_exact(self._sock, len(ACK_OK))
            except OSError as e:
                raise HandoffError(f"handoff send failed: {e}") from e
        if ack != ACK_OK:
            raise HandoffError(
                f"handoff rejected by receiver (ack {ack!r}) — payload "
                f"for {meta.get('rid')!r} was NOT imported")

    def close(self) -> None:
        self._sock.close()

    def __enter__(self) -> "HandoffChannel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HandoffServer:
    """Receiver side: a background accept loop (stdlib socket server)
    that reads frames and hands each ``(meta, K, V)`` to ``on_payload``.
    The callback's return or raise is the ack: return -> ``OK``, raise ->
    ``ER`` (the sender keeps custody and recovers).  Binds
    ``127.0.0.1:0`` by default: the process-split boundary on one
    host."""

    def __init__(self, on_payload: Callable[[Dict, torch.Tensor,
                                             torch.Tensor], None],
                 host: str = "127.0.0.1", port: int = 0):
        self._on_payload = on_payload
        self._listener = socket.create_server((host, port))
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._accept: Optional[threading.Thread] = None
        self._conns: List[threading.Thread] = []
        self.frames_ok = 0
        self.frames_err = 0

    def start(self) -> "HandoffServer":
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="handoff-accept",
                                        daemon=True)
        self._accept.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="handoff-conn", daemon=True)
            t.start()
            self._conns.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    frame = recv_frame(conn)
                except HandoffError:
                    self.frames_err += 1
                    try:
                        conn.sendall(ACK_ERR)
                    except OSError:
                        pass
                    return  # a torn stream cannot be resynchronized
                if frame is None:
                    return
                meta, k, v = frame
                try:
                    self._on_payload(meta, k, v)
                except Exception:
                    self.frames_err += 1
                    conn.sendall(ACK_ERR)
                else:
                    self.frames_ok += 1
                    conn.sendall(ACK_OK)
        except OSError:
            pass  # peer vanished; sender sees the tear on its side
        finally:
            conn.close()

    def stop(self) -> None:
        self._stop.set()
        self._listener.close()
        if self._accept is not None:
            self._accept.join(timeout=5.0)
        for t in self._conns:
            t.join(timeout=5.0)

    def __enter__(self) -> "HandoffServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
