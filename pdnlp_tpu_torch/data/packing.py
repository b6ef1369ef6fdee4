"""Packed rows: many examples per fixed-width row
(``pdnlp_tpu/data/packing.py``).

Training (``--length_mode pack``): :class:`PackedClassificationDataset`
packs an encoded split best-fit-decreasing into rows with segment channels,
and :class:`MultiWidthPackedDataset` packs each length bucket at its own
width.  Serving: :func:`pack_id_lists` bin-packs ragged token-id lists into
one ``[rows, seq_len]`` batch.  :func:`segment_bias` is the block-diagonal
mask the plain attention path builds from the segment IDs (the flash
kernel computes the same mask in-kernel from the IDs instead).  Packing is
numpy on the host, byte for byte the JAX package's.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.data.collate import EncodedDataset


class _BfdPacker:
    """Best-fit-decreasing placement: fed items longest first, each goes to
    the open row with the least free space that still fits it (a
    bisect-sorted ``(free, row)`` list); a row at the segment cap closes.
    Ties break on row id.  The one copy of the placement rules, shared by
    the single-width packer and the multi-width seed and backfill passes."""

    def __init__(self, S: int, M: int):
        self.S, self.M = int(S), int(M)
        self.rows: List[List[int]] = []
        self._open: List[tuple] = []  # sorted (free_tokens, row_id)

    @property
    def has_open(self) -> bool:
        return bool(self._open)

    def place(self, i: int, L: int, open_new: bool = True) -> bool:
        """Place item ``i`` of ``L`` tokens; ``open_new=False`` keeps to the
        open rows (the backfill pass opens none)."""
        j = bisect.bisect_left(self._open, (L, -1))
        if j < len(self._open):
            free, rid = self._open.pop(j)
            self.rows[rid].append(i)
            if len(self.rows[rid]) < self.M and free - L > 0:
                bisect.insort(self._open, (free - L, rid))
            return True
        if not open_new:
            return False
        self.rows.append([i])
        if self.M > 1 and self.S - L > 0:
            bisect.insort(self._open, (self.S - L, len(self.rows) - 1))
        return True


def _bfd_rows(lengths: np.ndarray, S: int, M: int) -> List[List[int]]:
    """Pack every item, longest first; rows of positions into ``lengths``."""
    packer = _BfdPacker(S, M)
    for i in np.argsort(-np.asarray(lengths), kind="stable").tolist():
        packer.place(i, int(lengths[i]))
    return packer.rows


def segment_cap(width: int, base_cap: int, base_width: int = 128) -> int:
    """Segments per row at ``width``: ``--pack_max_segments`` is set at the
    128-token base width and scales with the row width, so a 512-wide row
    admits 4x the segments of a 128-wide one."""
    return max(1, int(base_cap) * int(width) // int(base_width))


class PackedClassificationDataset(EncodedDataset):
    """Classification examples packed many per row (``--length_mode
    pack``).

    It has :class:`EncodedDataset`'s ``arrays`` / ``take`` / ``lengths``, so
    the loader, the resident pipeline and its budget check take it as they
    are; the unit is a packed row instead of an example.  Channels per row:

    - ``input_ids`` ``[N, S]``: ``[CLS] text [SEP]`` segments back to back;
    - ``segment_ids`` ``[N, S]``: 1-based per segment, 0 = padding: the
      attention mask (in-kernel on the flash route);
    - ``position_ids`` ``[N, S]``: restarting at 0 in every segment;
    - ``attention_mask`` ``[N, S]``: ``segment_ids > 0``;
    - ``cls_positions`` ``[N, M]``: each segment's [CLS] offset;
    - ``label`` / ``example_weight`` ``[N, M]``: per-segment targets and
      weights (0 = empty slot), so the loss stays per example.

    ``width`` sets the row width (default: the encoding width);
    ``subset`` packs only those encoded examples; ``rows`` (lists of
    encoded-example indices) skips the packer and assembles exactly those
    rows (the multi-width container packs for itself).

    Packing runs once, deterministic in the data: epochs shuffle packed
    rows, so steps per epoch stay fixed.
    """

    def __init__(self, encoded: EncodedDataset, max_segments: int = 16,
                 width: Optional[int] = None,
                 subset: Optional[Sequence[int]] = None,
                 rows: Optional[List[List[int]]] = None):
        S = int(width) if width else encoded.seq_len
        M = int(max_segments)
        if M < 1:
            raise ValueError(f"pack_max_segments must be >= 1, got {M}")
        all_len = encoded.lengths()
        if rows is None:
            members_idx = (np.arange(len(encoded), dtype=np.int64)
                           if subset is None
                           else np.asarray(subset, np.int64))
            lengths = all_len[members_idx]
            if len(members_idx) and int(lengths.max()) > S:
                raise ValueError(
                    f"cannot pack a {int(lengths.max())}-token example "
                    f"into {S}-wide rows: the packing width must cover "
                    "every member (partition by covering width first)")
            rows_pos = _bfd_rows(lengths, S, M)
            rows = [[int(members_idx[i]) for i in r] for r in rows_pos]
            n = len(members_idx)
        else:
            rows = [[int(i) for i in r] for r in rows]
            for r in rows:
                if len(r) > M:
                    raise ValueError(f"row carries {len(r)} segments, "
                                     f"cap is {M}")
                if int(all_len[r].sum()) > S:
                    raise ValueError("row overflows the packing width")
            n = sum(len(r) for r in rows)
        N = len(rows)
        src_ids = encoded.arrays["input_ids"]
        src_lab = encoded.arrays["label"]
        input_ids = np.zeros((N, S), np.int32)
        segment_ids = np.zeros((N, S), np.int32)
        position_ids = np.zeros((N, S), np.int32)
        cls_pos = np.zeros((N, M), np.int32)
        label = np.zeros((N, M), np.int32)
        weight = np.zeros((N, M), np.float32)
        for r, members in enumerate(rows):
            off = 0
            for s, orig in enumerate(members):
                L = int(all_len[orig])
                input_ids[r, off: off + L] = src_ids[orig, :L]
                segment_ids[r, off: off + L] = s + 1
                # positions restart per segment: each example sees the
                # position embeddings of its unpacked encoding
                position_ids[r, off: off + L] = np.arange(L, dtype=np.int32)
                cls_pos[r, s] = off
                label[r, s] = src_lab[orig]
                weight[r, s] = 1.0
                off += L
        self.arrays = {
            "input_ids": input_ids,
            "segment_ids": segment_ids,
            "position_ids": position_ids,
            "attention_mask": (segment_ids > 0).astype(np.int32),
            "token_type_ids": np.zeros((N, S), np.int32),
            "cls_positions": cls_pos,
            "label": label,
            "example_weight": weight,
        }
        self.n = N
        self.seq_len = S
        self.max_segments = M
        self.num_examples = n
        #: per packed row, the encoded-example indices riding it
        self.source_rows: List[List[int]] = [list(r) for r in rows]

    def stats(self) -> Dict[str, float]:
        """Packing efficiency: rows, examples, real tokens, fill ratio and
        segments per row."""
        seg_counts = (self.arrays["example_weight"] > 0).sum(1)
        tokens_real = int(self.arrays["attention_mask"].sum())
        return {
            "rows": self.n,
            "examples": self.num_examples,
            "tokens_real": tokens_real,
            "fill_ratio": tokens_real / float(self.n * self.seq_len)
            if self.n else 0.0,
            "segments_per_row_mean": float(seg_counts.mean())
            if self.n else 0.0,
            "segments_per_row_max": int(seg_counts.max()) if self.n else 0,
        }


def pack_classification(encoded: EncodedDataset, max_segments: int = 16
                        ) -> PackedClassificationDataset:
    """Pack an encoded classification split into multi-example rows."""
    return PackedClassificationDataset(encoded, max_segments=max_segments)


class MultiWidthPackedDataset:
    """Each example packs at its smallest covering width (``--length_mode
    pack`` with several widths that are multiples of 128 in
    ``--length_buckets``), each width with its own segment cap
    (:func:`segment_cap`), so short examples ride dense 128-wide rows and
    long documents 256-512-wide ones instead of padding all to the widest.

    Widest first, with backfill: a width's rows are seeded
    best-fit-decreasing by the examples that need it, then topped up from
    the still-unpacked shorter examples (longest first, no new rows).

    Rows live in one index space (width groups in ascending width order);
    a :class:`~pdnlp_tpu_torch.data.sampler.LengthGroupedSampler` over
    :meth:`row_width_table` with the widths as buckets batches them
    width-homogeneously.  There is no single rectangular array set, so the
    resident pipeline declines it and ``--pipeline auto`` takes prefetch.
    """

    def __init__(self, encoded: EncodedDataset, widths: Sequence[int],
                 max_segments: int = 16, base_width: int = 128):
        ws = tuple(sorted(int(w) for w in set(widths)))
        if not ws:
            raise ValueError("need at least one packing width")
        lengths = encoded.lengths()
        if len(encoded) and int(lengths.max()) > ws[-1]:
            raise ValueError(
                f"longest example ({int(lengths.max())} tokens) exceeds "
                f"the largest packing width {ws[-1]}: include a covering "
                "width in --length_buckets")
        edges = np.asarray(ws, np.int64)
        member = edges[np.minimum(np.searchsorted(edges, lengths),
                                  len(edges) - 1)]
        remaining = {w: set(np.flatnonzero(member == w).tolist())
                     for w in ws}
        rows_by_width: Dict[int, List[List[int]]] = {}
        for w in reversed(ws):
            packer = _BfdPacker(w, segment_cap(w, max_segments, base_width))
            need = sorted(remaining[w], key=lambda i: (-lengths[i], i))
            remaining[w] = set()
            for i in need:                # seed: the width's own members
                packer.place(i, int(lengths[i]))
            pool = sorted((i for w2 in ws if w2 < w for i in remaining[w2]),
                          key=lambda i: (-lengths[i], i))
            for i in pool:                # backfill: no new rows opened
                if not packer.has_open:
                    break
                if packer.place(i, int(lengths[i]), open_new=False):
                    remaining[edges[np.searchsorted(edges,
                                                    lengths[i])]].discard(i)
            if packer.rows:
                rows_by_width[w] = packer.rows
        self.widths = ws
        self.groups: Dict[int, PackedClassificationDataset] = {}
        self._offsets: Dict[int, int] = {}
        off = 0
        for w in ws:
            if w not in rows_by_width:
                continue
            g = PackedClassificationDataset(
                encoded, max_segments=segment_cap(w, max_segments,
                                                  base_width),
                width=w, rows=rows_by_width[w])
            self.groups[w] = g
            self._offsets[w] = off
            off += g.n
        self.n = off
        self.seq_len = ws[-1]
        self.num_examples = len(encoded)

    def __len__(self) -> int:
        return self.n

    def row_width_table(self) -> np.ndarray:
        """``[n]`` row widths: the ``lengths`` of the sampler that batches
        this dataset, whose covering bucket is then the row's width."""
        out = np.zeros((self.n,), np.int64)
        for w, g in self.groups.items():
            off = self._offsets[w]
            out[off: off + g.n] = w
        return out

    def lengths(self) -> np.ndarray:
        """Real tokens per packed row."""
        out = np.zeros((self.n,), np.int64)
        for w, g in self.groups.items():
            off = self._offsets[w]
            out[off: off + g.n] = g.lengths()
        return out

    def take(self, indices: Sequence[int], pad_to: int = 0,
             seq_len: int = 0) -> Dict[str, np.ndarray]:
        """One width-homogeneous batch of packed rows; ``seq_len`` names
        the width, and an index of another width's group raises."""
        w = int(seq_len) or self.seq_len
        if w not in self.groups:
            raise ValueError(f"no packed rows at width {w} "
                             f"(have {sorted(self.groups)})")
        off, g = self._offsets[w], self.groups[w]
        local = np.asarray(indices, np.int64) - off
        if len(local) and (local.min() < 0 or local.max() >= g.n):
            raise ValueError(
                f"batch mixes widths: indices outside the width-{w} group")
        return g.take(local, pad_to=pad_to)

    def stats(self) -> Dict[str, object]:
        """Per-width packing stats and the token-weighted fill."""
        per = {int(w): g.stats() for w, g in self.groups.items()}
        slots = sum(g.n * w for w, g in self.groups.items())
        real = sum(int(g.arrays["attention_mask"].sum())
                   for g in self.groups.values())
        return {"by_width": per,
                "rows": self.n,
                "examples": self.num_examples,
                "fill_ratio": real / float(slots) if slots else 0.0}


def pack_id_lists(
    id_lists: Sequence[Sequence[int]],
    seq_len: int,
    rows: int,
    max_segments: int,
    pad_id: int = 0,
) -> Tuple[Dict[str, np.ndarray], List[Optional[Tuple[int, int]]]]:
    """Bin-pack ragged token-id lists into ONE fixed ``[rows, seq_len]``
    packed batch.

    The caller's order is the priority order: placement is first-fit over
    the open rows in order, and a list that fits nowhere right now is
    skipped while later, shorter lists may still fill the gaps it left.
    Positions restart per segment, so each request sees exactly the
    position embeddings of its own padded forward.

    Returns ``(batch, placements)``: ``placements[i]`` is the ``(row, slot)``
    the ``i``-th list landed at, or ``None`` if it did not fit.  ``batch``
    always has the full ``rows x seq_len`` shape (unused rows stay padding).
    """
    S, R, M = int(seq_len), int(rows), int(max_segments)
    if R < 1 or M < 1:
        raise ValueError(f"need rows >= 1 and max_segments >= 1, "
                         f"got rows={R} max_segments={M}")
    input_ids = np.full((R, S), pad_id, np.int32)
    segment_ids = np.zeros((R, S), np.int32)
    position_ids = np.zeros((R, S), np.int32)
    cls_pos = np.zeros((R, M), np.int32)
    used = [0] * R     # tokens occupied per row
    segs = [0] * R     # segments opened per row
    opened = 0         # rows touched so far (first-fit opens them in order)
    placements: List[Optional[Tuple[int, int]]] = []
    for ids in id_lists:
        L = len(ids)
        if L > S:
            raise ValueError(f"list of {L} tokens exceeds the {S}-token "
                             "pack width — truncate before packing")
        if L == 0:
            # a phantom segment's cls_positions entry would alias the next
            # segment's offset and hand its caller a neighbor's logits
            raise ValueError("empty id list cannot be packed — reject "
                             "empty requests before batch formation")
        row = next((r for r in range(opened)
                    if segs[r] < M and used[r] + L <= S), None)
        if row is None:
            if opened >= R:
                placements.append(None)  # full batch: ride the next one
                continue
            row = opened
            opened += 1
        off = used[row]
        input_ids[row, off: off + L] = np.asarray(ids, np.int32)
        segment_ids[row, off: off + L] = segs[row] + 1
        position_ids[row, off: off + L] = np.arange(L, dtype=np.int32)
        cls_pos[row, segs[row]] = off
        placements.append((row, segs[row]))
        used[row] += L
        segs[row] += 1
    batch = {
        "input_ids": input_ids,
        "segment_ids": segment_ids,
        "position_ids": position_ids,
        "attention_mask": (segment_ids > 0).astype(np.int32),
        "token_type_ids": np.zeros((R, S), np.int32),
        "cls_positions": cls_pos,
    }
    return batch, placements


def segment_bias(segment_ids: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, S]`` segment IDs -> ``[B, 1, S, S]`` additive attention bias:
    0 where query and key share a nonzero segment, -1e9 elsewhere.

    Built only by the plain attention path; the flash kernel derives the
    same mask on chip from the IDs."""
    q = segment_ids[:, :, None]
    k = segment_ids[:, None, :]
    same = ((q == k) & (q > 0)).to(dtype)
    return ((1.0 - same) * -1e9)[:, None, :, :]
