"""The one generator of the benchmark's inputs: FASTA files, from a
traffic mix's parameters and a seed, of a hashed background with
reference genes planted into loci, or of the real contigs of a FASTA
file, each cut at another point of its circle and in either orientation.

``hash_codes`` and the 80-column writer are copies of chip_smoke.py's
``hash_codes`` and ``write_fasta`` at commit 643846b (the JAX bench's
splitmix-style background), moved onto the device: the hash runs on the
card in int64 arithmetic held to 32 bits, so a seed gives the same bytes
on any device.  The layout (record order, plant positions, gene order,
substitution rates and sites) comes from NumPy's generator seeded with
the seed, and is the same for every device too.

A mix's parameters (``benchmark/traffic/<mix>.json``):

- ``files``: how many distinct files; the caller cycles through them.
- ``source``: a FASTA file (a path from the checkout's root): every file
  holds each of its records, in an order drawn from the seed, each rotated
  by an offset drawn from the seed (a clone's circular insert, linearised
  at another point) and reverse-complemented in half of the files, which
  half drawn from the seed, so that every seed has the same sizes and the
  same records in each orientation.  A mix gives ``source`` or ``records``.
- ``records``: [{"name", "length", optional "locus"}] in order, then
  ``scaffolds`` {"count", "min_length", "max_length", "name"}: ``count``
  records of lengths evenly spaced from min to max, in an order drawn from
  the seed, so that every seed has the same total.
- ``locus``: {"last_bp", "spacing", "jitter", optional "count"}: genes
  planted in the record's last ``last_bp`` bp, one every ``spacing`` bp
  from ``spacing / 2``, each moved by a uniform draw in +-``jitter``, at most
  ``count`` of them; the genes cycle through the reference set in an order
  drawn from the seed, carried over from record to record and file to file.
- ``substitutions``: [lo, hi]: each planted copy has a substitution rate
  drawn uniformly from [lo, hi); each of its bases changes with that
  probability to one of the three others.
- ``line_width``: letters a FASTA line.
- ``profile_calls``: calls the traced run profiles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .spec import ROOT

_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x < 2^32, in int64 without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _salt(seed: int) -> int:
    """A 32-bit salt from any non-negative seed (splitmix64's finaliser)."""
    z = (seed + 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


def hash_codes(n: int, offset: int, seed: int, device) -> torch.Tensor:
    """2-bit codes of a splitmix-style hash of each position (uint8); the
    seed's salt is XORed in after the first product, so two seeds give
    unrelated backgrounds, not shifted copies of one."""
    if offset + n > 1 << 32:
        raise ValueError("the hashed background holds 2^32 positions")
    x = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x = _mul32(x, 0x9E3779B9) ^ _salt(seed)
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return ((x >> 7) & 3).to(torch.uint8)


@dataclass
class Plant:
    pos: int  # 0-based start in the record
    gene: int  # index into the reference set
    rate: float  # substitution rate of this copy


@dataclass
class Record:
    name: str
    length: int
    plants: list[Plant] = field(default_factory=list)
    source: "int | None" = None  # index of the source record, or None for a hashed background
    rotation: int = 0  # the source record rotated left by this many bp
    reverse: bool = False  # the source record reverse-complemented (before the rotation)


def source_records(params: dict, root: Path) -> list[tuple[str, bytes]]:
    """The (header, upper-case letters) of the mix's source FASTA; none
    without a ``source``."""
    from ..reference.fasta import read_fasta

    if not params.get("source"):
        return []
    return [(d, s.upper()) for d, s in read_fasta(Path(root) / params["source"])]


def _source_layout(params: dict, rng: np.random.Generator, sources: list[tuple[str, bytes]]) -> list[list[Record]]:
    n_files = params["files"]
    reverse = [set(rng.permutation(n_files)[: n_files // 2].tolist()) for _ in sources]
    files = []
    for fi in range(n_files):
        recs = []
        for i in rng.permutation(len(sources)):
            header, seq = sources[i]
            rot = int(rng.integers(0, len(seq)))
            recs.append(Record(header.split()[0], len(seq), source=int(i), rotation=rot, reverse=fi in reverse[i]))
        files.append(recs)
    return files


def layout(params: dict, seed: int, n_genes: int, gene_lengths: list[int], sources=()) -> list[list[Record]]:
    """The records of every file, with their plants; ``sources`` are the
    mix's ``source_records``."""
    rng = np.random.default_rng(seed)
    if params.get("source"):
        return _source_layout(params, rng, list(sources))
    order = rng.permutation(n_genes)
    cursor = 0
    lo, hi = params["substitutions"]
    files = []
    for _ in range(params["files"]):
        recs = [Record(r["name"], int(r["length"])) for r in params["records"]]
        locus = [r.get("locus") for r in params["records"]]
        sc = params.get("scaffolds")
        if sc:
            lengths = np.linspace(sc["min_length"], sc["max_length"], sc["count"]).round().astype(int)
            for i, j in enumerate(rng.permutation(sc["count"])):
                recs.append(Record(f"{sc['name']}{i + 1}", int(lengths[j])))
                locus.append(None)
        for rec, loc in zip(recs, locus):
            if not loc:
                continue
            start = max(0, rec.length - int(loc["last_bp"]))
            limit = loc.get("count")
            pos = start + loc["spacing"] // 2
            while limit is None or len(rec.plants) < limit:
                gene = int(order[cursor % n_genes])
                p = pos + int(rng.integers(-loc["jitter"], loc["jitter"] + 1)) if loc["jitter"] else pos
                if p < start or p + gene_lengths[gene] > rec.length:
                    break
                rec.plants.append(Plant(p, gene, float(rng.uniform(lo, hi))))
                cursor += 1
                pos += loc["spacing"]
        files.append(recs)
    return files


def mutate(gene: bytes, rate: float, rng: np.random.Generator) -> bytes:
    letters = np.frombuffer(gene.upper(), dtype=np.uint8).copy()
    sites = np.flatnonzero(rng.random(letters.size) < rate)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    for s in sites:
        others = alphabet[alphabet != letters[s]]
        letters[s] = others[rng.integers(0, others.size)]
    return letters.tobytes()


def _from_source(seq: bytes, rec: Record, device) -> torch.Tensor:
    out = torch.frombuffer(bytearray(seq), dtype=torch.uint8).to(device)
    if rec.reverse:
        complement = torch.arange(256, dtype=torch.uint8, device=device)
        complement[list(b"ACGT")] = torch.tensor(list(b"TGCA"), dtype=torch.uint8, device=device)
        out = complement[out.flip(0).long()]
    return torch.roll(out, -rec.rotation) if rec.rotation else out


def write_file(path: Path, records: list[Record], file_index: int, offset: int, seed: int, genes: list[bytes], line_width: int, device, sources=()) -> int:
    """Write one file, its hashed background from hash position ``offset``
    on; returns the offset after it."""
    letters_lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=device)
    with open(path, "wb") as fh:
        for ri, rec in enumerate(records):
            if rec.source is not None:
                seq = _from_source(sources[rec.source][1], rec, device)
                how = f"{sources[rec.source][0]}, rotated by {rec.rotation} bp" + (", reverse complement" if rec.reverse else "")
            else:
                seq = letters_lut[hash_codes(rec.length, offset, seed, device).long()]
                offset += rec.length
                how = f"{rec.name} synthetic record {ri + 1}"
            for pi, plant in enumerate(rec.plants):
                rng = np.random.default_rng([seed & _MASK, seed >> 32, file_index, ri, pi])
                copy = mutate(genes[plant.gene], plant.rate, rng)
                seq[plant.pos : plant.pos + len(copy)] = torch.frombuffer(bytearray(copy), dtype=torch.uint8).to(device)
            fh.write(f">{how}, file {file_index + 1}, seed {seed}\n".encode())
            full = rec.length // line_width * line_width
            lines = seq[:full].view(-1, line_width)
            breaks = torch.full((lines.shape[0], 1), 10, dtype=torch.uint8, device=device)
            fh.write(torch.cat([lines, breaks], 1).cpu().numpy().tobytes())
            if full < rec.length:
                fh.write(seq[full:].cpu().numpy().tobytes() + b"\n")
            del seq
        # written back to disk in set-up, so that the write-back of a
        # 400 MB file does not run on into the window
        fh.flush()
        os.fsync(fh.fileno())
    return offset


def make(params: dict, seed: int, genes: list[bytes], out_dir: Path, device, root: Path = ROOT) -> tuple[list[Path], list[list[Record]]]:
    """Write the mix's files into ``out_dir``; (paths, layouts)."""
    sources = source_records(params, root)
    files = layout(params, seed, len(genes), [len(g) for g in genes], sources)
    paths = []
    offset = 0
    for fi, recs in enumerate(files):
        path = Path(out_dir) / f"input_{fi:03d}.fasta"
        offset = write_file(path, recs, fi, offset, seed, genes, int(params.get("line_width", 80)), device, sources)
        paths.append(path)
    return paths, files
