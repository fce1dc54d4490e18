"""Scan checkpoint/resume (the port's copy of
``kmergma_tpu.utils.checkpoint``).

Each contig's scan is stateless given (profile, contig), so checkpointing
a long multi-contig scan reduces to recording the last fully-processed
record index plus the hits accumulated so far; resuming replays from the
next record.  The checkpoint is a JSON file replaced atomically after each
record (written to a temporary file in the same directory, then
``os.replace``d), and removed by ``done()`` when the run completes.

The file format is the JAX package's, key for key, mid-record keys
included (``seg_record``, ``seg_next``, ``seg_words``,
``seg_fingerprint``), and the miners build the same identity strings, so a
checkpoint written by either package resumes in the other.

``SegmentTracker`` holds mid-record progress: each finished segment's
packed bitmap words.  The miners hand one to the engine for each record,
and three engines call it: ``ScanEngine`` on a segmented record (more than
2 x chunk windows of host codes), ``ShardedScanEngine`` and
``ShardedClusterScanEngine`` on a record of more than one segment batch
(parallel/sharded_scan.py).  The engines' fingerprints are the JAX
engines', so a record killed half-way by either package resumes after its
last finished segment in the other.  The one-device cluster engine, the
strobemer engine and the int64 host engine take whole records and ignore
it, as in the JAX package.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

from .fasta import FastaRecord


@dataclass
class SegmentTracker:
    """Per-record segment progress adapter for a segmented bitmap pass."""

    ckpt: "ScanCheckpoint"
    record_idx: int

    def resume(self, fingerprint: str) -> tuple[int, list[np.ndarray]]:
        """(#completed segments, their packed uint32 word arrays).

        ``fingerprint`` encodes every engine parameter that shapes the
        stored words (chunk/block/threshold/...); persisted segments from a
        run with DIFFERENT parameters are discarded instead of silently
        misinterpreted (their word layout and segment offsets differ).
        """
        c = self.ckpt
        if (
            c.seg_record != self.record_idx
            or c.seg_next == 0
            or c.seg_fingerprint != fingerprint
        ):
            return 0, []
        return c.seg_next, [
            np.frombuffer(base64.b64decode(b), dtype=np.uint32) for b in c.seg_words
        ]

    def done_segment(self, seg_idx: int, words: np.ndarray, fingerprint: str) -> None:
        c = self.ckpt
        if c.seg_record != self.record_idx or c.seg_fingerprint != fingerprint:
            c.seg_record = self.record_idx
            c.seg_next = 0
            c.seg_words = []
            c.seg_fingerprint = fingerprint
        c.seg_words.append(
            base64.b64encode(
                np.ascontiguousarray(words, dtype=np.uint32).tobytes()
            ).decode("ascii")
        )
        c.seg_next = seg_idx + 1
        c._write()


@dataclass
class ScanCheckpoint:
    path: str
    genome_id: str  # identity guard (path + profile fingerprint)
    next_record: int = 0
    genome_pos: int = 0
    hits: list[dict] = field(default_factory=list)
    hit_loci: list[int] = field(default_factory=list)
    seg_record: int = -1  # record with partial (mid-record) progress
    seg_next: int = 0  # its next segment index
    seg_words: list[str] = field(default_factory=list)  # per-segment packed words (b64)
    seg_fingerprint: str = ""  # engine-parameter fingerprint of seg_words

    @classmethod
    def load_or_create(cls, path: str, genome_id: str) -> "ScanCheckpoint":
        if os.path.exists(path):
            with open(path) as fh:
                data = json.load(fh)
            if data.get("genome_id") == genome_id:
                return cls(
                    path=path,
                    genome_id=genome_id,
                    next_record=data["next_record"],
                    genome_pos=data["genome_pos"],
                    hits=data["hits"],
                    hit_loci=data.get("hit_loci", []),
                    seg_record=data.get("seg_record", -1),
                    seg_next=data.get("seg_next", 0),
                    seg_words=data.get("seg_words", []),
                    seg_fingerprint=data.get("seg_fingerprint", ""),
                )
        return cls(path=path, genome_id=genome_id)

    def segment_tracker(self, record_idx: int) -> SegmentTracker:
        return SegmentTracker(self, record_idx)

    def record_done(self, record_idx: int, genome_pos: int, new_hits: list[FastaRecord], new_loci: list[int]) -> None:
        self.next_record = record_idx + 1
        self.genome_pos = genome_pos
        self.hits.extend(
            {"description": h.description, "seq": h.seq_str()} for h in new_hits
        )
        self.hit_loci.extend(new_loci)
        self.seg_record, self.seg_next, self.seg_words = -1, 0, []
        self.seg_fingerprint = ""
        self._write()

    def _write(self) -> None:
        data = {
            "genome_id": self.genome_id,
            "next_record": self.next_record,
            "genome_pos": self.genome_pos,
            "hits": self.hits,
            "hit_loci": self.hit_loci,
            "seg_record": self.seg_record,
            "seg_next": self.seg_next,
            "seg_words": self.seg_words,
            "seg_fingerprint": self.seg_fingerprint,
        }
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        with os.fdopen(fd, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, self.path)

    def restore_hits(self) -> list[FastaRecord]:
        return [FastaRecord(h["description"], h["seq"].encode()) for h in self.hits]

    def done(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
