"""Exact-occurrence search in PyTorch (counterpart of
``kmergma_tpu.ops.exact_match``; ref KmerGMA.jl src/ExactMatch.jl).

Two engines behind one API:
  * a device scan (``match_starts_engine``): the subject's rolling 16-base
    2-bit register compared with the query's, masked to min(16, |q|) bases,
    so one pass serves every query and query length; any() per 512
    positions gives a block bitmap, one device-to-host copy brings it back,
    and ``bytes.find`` verifies the runs of active blocks on the host
    (random DNA flags a position with probability 4^-16);
  * ``bytes.find`` on the host for subjects under ``_DEVICE_MIN``.

The JAX version has no Pallas kernel here (a jitted XLA pass), so the
device scan is plain torch ops.  Matching is on raw uppercased sequence
bytes, so N only matches N, as ``ExactSearchQuery(isequal)`` does (the
2-bit register folds N into T, which only widens the candidate set the
byte verification filters).

Overlap semantics (ref ExactMatch.jl:20-43): overlap=True restarts the
search one past each match START (every occurrence); overlap=False one past
each match END (greedy non-overlapping).
"""

from __future__ import annotations

import hashlib
import os
from typing import Union

import numpy as np
import torch

from ..consts import encode_seq
from ..utils.fasta import FastaRecord, PathOrRecords, as_records, read_fasta
from .scan import resolve_device

Query = Union[str, bytes, FastaRecord]

_DEVICE_MIN = 1 << 20  # below this, bytes.find beats a device round trip
_PREFIX = 16  # bases folded into the 32-bit match register
_BLOCK = 512  # positions per activity-bitmap block
_SPAN = 1 << 24  # positions per device pass (bounds the int32 temporaries)


def _as_bytes(x: Query) -> bytes:
    if isinstance(x, FastaRecord):
        return x.seq.upper()
    if isinstance(x, str):
        return x.upper().encode("ascii")
    return bytes(x).upper()


def match_starts_np(subject: bytes, query: bytes) -> np.ndarray:
    """All 0-based match start positions (host path, bytes.find)."""
    out = []
    start = subject.find(query)
    while start != -1:
        out.append(start)
        start = subject.find(query, start + 1)
    return np.asarray(out, dtype=np.int64)


def _ranges(starts: np.ndarray, qlen: int, overlap: bool) -> list[tuple[int, int]]:
    """1-based inclusive ranges with the reference's restart semantics."""
    out: list[tuple[int, int]] = []
    next_allowed = 0
    for s in starts:
        s = int(s)
        if overlap or s >= next_allowed:
            out.append((s + 1, s + qlen))
            next_allowed = s + qlen
    return out


def exact_match(
    query: Query,
    subject: "Query | PathOrRecords",
    overlap: bool = True,
    use_device: bool | None = None,
    *,
    device: "str | torch.device" = "cuda",
):
    """All exact occurrences of ``query`` in ``subject``.

    Sequence/record subject -> list of 1-based (start, stop) tuples, or
    ``None`` if no match.  Path / record-collection subject -> dict mapping
    record identifier to its range list, or the string "no match"
    (ref ExactMatch.jl:89-121).  ``device`` is resolved first (the card
    unless the caller asks for the CPU; raises without CUDA); subjects of at
    least ``_DEVICE_MIN`` bases then take the device scan there, unless
    ``use_device`` says otherwise.
    """
    dev = resolve_device(device)
    q = _as_bytes(query)
    if not q:
        raise ValueError("empty query sequence")

    if isinstance(subject, (str, bytes)) and not _looks_like_path(subject):
        return _match_one(q, _as_bytes(subject), overlap, use_device, dev)
    if isinstance(subject, FastaRecord):
        return _match_one(q, _as_bytes(subject), overlap, use_device, dev)

    # path or iterable of records
    records = list(read_fasta(subject)) if _looks_like_path(subject) else as_records(subject)
    found: dict[str, list[tuple[int, int]]] = {}
    for rec in records:
        rng = _match_one(q, _as_bytes(rec), overlap, use_device, dev)
        if rng is not None:
            found[rec.identifier] = rng
    return found if found else "no match"


def _looks_like_path(x) -> bool:
    return isinstance(x, (str, bytes)) and os.path.exists(x)


class SubjectCache:
    """Subjects' padded device codes, by content (``_subject_key``), held
    under a byte budget: the oldest entries go first when a new one would
    exceed it, and a single subject over the budget is still kept alone so
    repeated queries reuse its transfer.  There is no cap on the number of
    entries (the JAX package's ``clear()`` at four entries defeated the
    budget, ADVICE r5)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._entries: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def held_bytes(self) -> int:
        return sum(t.numel() for t in self._entries.values())

    def get(self, key):
        return self._entries.get(key)

    def put(self, key, codes: torch.Tensor) -> None:
        held = self.held_bytes()
        while self._entries and held + codes.numel() > self.max_bytes:
            oldest = next(iter(self._entries))
            held -= self._entries.pop(oldest).numel()
        self._entries[key] = codes


#: the device copies of recent subjects, at most 1 GiB of int8 codes
_subject_cache = SubjectCache(1 << 30)


def _query_register(q: bytes) -> tuple[int, int]:
    """(masked register, mask) of the query's first min(16, |q|) bases,
    as int32 bit patterns (MSB-aligned, low bits free)."""
    kp = min(_PREFIX, len(q))
    qcodes = encode_seq(q[:kp]).astype(np.uint32)
    reg = np.uint32(0)
    for c in qcodes:
        reg = np.uint32((int(reg) << 2) | int(c))
    reg = np.uint32((int(reg) << (2 * (_PREFIX - kp))) & 0xFFFFFFFF)
    mask = np.uint32((0xFFFFFFFF << (32 - 2 * kp)) & 0xFFFFFFFF)
    i32 = lambda u: int(np.asarray([u], dtype=np.uint32).view(np.int32)[0])
    return i32(np.uint32(int(reg) & int(mask))), i32(mask)


def _subject_key(sub: bytes, device: "str | torch.device") -> tuple:
    """A subject's cache key: its length, a digest of its bytes and the
    device, so equal subjects share one entry whatever object holds them
    (``_as_bytes`` builds a new one on every call)."""
    return len(sub), hashlib.blake2b(sub, digest_size=16).digest(), str(device)


def _subject_codes(sub: bytes, device: torch.device, cache: SubjectCache) -> torch.Tensor:
    """The subject's int8 codes on ``device``, zero-padded by a whole block
    and the register's reach; one host-to-device copy per subject while it
    stays in ``cache``."""
    n = len(sub)
    key = _subject_key(sub, device)
    codes = cache.get(key)
    if codes is None:
        total = -(-n // _BLOCK) * _BLOCK + _BLOCK + _PREFIX
        padded = np.zeros(total, dtype=np.int8)
        padded[:n] = encode_seq(sub)
        codes = torch.from_numpy(padded).to(device)
        cache.put(key, codes)
    return codes


def match_starts_engine(sub: bytes, q: bytes, *, device: "str | torch.device" = "cuda", cache: SubjectCache | None = None) -> np.ndarray:
    """Exact occurrences via the device prefix-register scan on ``device``
    (the card unless the caller asks for the CPU).

    Per span of positions: the rolling 16-base int32 register (16 shifted
    adds, int32 wraparound as on the host), the masked compare with the
    query's register, any() per 512 positions; then one device-to-host
    copy of the whole bitmap, and ``bytes.find`` over each run of active
    blocks on the host.  ``cache`` keeps the subjects' device codes
    (``_subject_cache`` by default)."""
    dev = resolve_device(device)
    cache = _subject_cache if cache is None else cache
    n_valid = len(sub) - len(q) + 1
    if n_valid < 1:
        return np.empty(0, dtype=np.int64)
    codes = _subject_codes(sub, dev, cache)
    reg, mask = _query_register(q)
    n_blocks = -(-n_valid // _BLOCK)
    parts = []
    for lo in range(0, n_blocks * _BLOCK, _SPAN):
        span = min(_SPAN, n_blocks * _BLOCK - lo)
        c = codes[lo : lo + span + _PREFIX - 1].to(torch.int32)
        r = torch.zeros(span, dtype=torch.int32, device=dev)
        for t in range(_PREFIX):
            r += c[t : t + span] << (2 * (_PREFIX - 1 - t))
        pos = torch.arange(lo, lo + span, device=dev)
        hit = ((r & mask) == reg) & (pos < n_valid)
        parts.append(hit.view(-1, _BLOCK).any(dim=1))
    bm = torch.cat(parts).cpu().numpy()

    out: list[int] = []
    active = np.nonzero(bm)[0]
    if active.size:
        run_breaks = np.nonzero(np.diff(active) > 1)[0]
        run_lo = np.concatenate([[0], run_breaks + 1])
        run_hi = np.concatenate([run_breaks, [active.size - 1]])
        for lo_i, hi_i in zip(run_lo, run_hi):
            lo = int(active[lo_i]) * _BLOCK
            hi = min((int(active[hi_i]) + 1) * _BLOCK, n_valid)
            start = sub.find(q, lo)
            while start != -1 and start < hi:
                out.append(start)
                start = sub.find(q, start + 1)
    return np.asarray(out, dtype=np.int64)


def _match_one(q: bytes, sub: bytes, overlap: bool, use_device: bool | None, device: torch.device):
    if len(sub) < len(q):
        return None
    if use_device is None:
        use_device = len(sub) >= _DEVICE_MIN
    starts = match_starts_engine(sub, q, device=device) if use_device else match_starts_np(sub, q)
    if starts.size == 0:
        return None
    return _ranges(starts, len(q), overlap)


def first_match(source: PathOrRecords, query: Query) -> list[tuple[str, tuple[int, int]]]:
    """First occurrence per record (ref ExactMatch.jl:8-16; returns instead
    of printing)."""
    q = _as_bytes(query)
    out = []
    for rec in as_records(source):
        sub = _as_bytes(rec)
        pos = sub.find(q)
        if pos != -1:
            out.append((rec.identifier, (pos + 1, pos + len(q))))
    return out
