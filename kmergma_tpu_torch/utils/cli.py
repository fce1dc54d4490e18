"""Command-line interface of the port (counterpart of
``kmergma_tpu.utils.cli``): the same four subcommands and flags, calling
the port's API, plus ``--device {cuda,cpu}`` (default ``cuda``):

    python -m kmergma_tpu_torch find-genes --genome g.fasta --refs refs.fasta -o hits.fasta
    python -m kmergma_tpu_torch find-genes-cluster --genome g.fasta --refs refs.fasta
    python -m kmergma_tpu_torch strobe-find-genes --genome g.fasta --refs refs.fasta
    python -m kmergma_tpu_torch exact-match --query ACGT... --subject g.fasta

``--checkpoint FILE`` checkpoints each scan per record and resumes an
interrupted one from the same file (a file written by the JAX package's
CLI resumes here, and the other way round).  ``--devices`` reaches the
API, which does not support it yet: the CLI prints its message and exits
with status 2.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="run on the GPU (default) or on the CPU",
    )


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--genome", required=True, help="genome fasta path")
    p.add_argument("--refs", required=True, help="reference-set fasta path")
    p.add_argument("-o", "--out", default=None, help="output fasta (default: stdout)")
    p.add_argument("--buffer", type=int, default=None)
    p.add_argument("--no-align", action="store_true")
    p.add_argument("--gap-open", type=int, default=None)
    p.add_argument("--gap-extend", type=int, default=None)
    p.add_argument("--hit-loci", action="store_true", help="print hit loci as JSON to stderr")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument(
        "--devices", type=int, default=None,
        help="run the scan over the first N devices (not ported yet)",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="checkpoint file for per-record resume of interrupted scans",
    )
    p.add_argument(
        "--stats", action="store_true",
        help="log scan observability counters (a 'scan stats:' JSON line)",
    )
    _add_device(p)


def _emit(hits, loci, args) -> None:
    from .fasta import write_fasta

    if args.out:
        write_fasta(hits, args.out)
    else:
        for h in hits:
            sys.stdout.write(f">{h.description}\n{h.seq_str()}\n")
    if args.hit_loci:
        print(json.dumps({"hit_loci": loci}), file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kmergma_tpu_torch",
        description="GPU homology scanning (KmerGMA-compatible), PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("find-genes", help="single-profile scan (findGenes)")
    _add_common(p1)
    p1.add_argument("-k", type=int, default=6)
    p1.add_argument("--thr", type=float, default=0, help="distance threshold (0 = auto)")

    p2 = sub.add_parser("find-genes-cluster", help="cluster-mode scan (findGenes_cluster_mode)")
    _add_common(p2)
    p2.add_argument("-k", type=int, default=6)
    p2.add_argument("--thr", type=float, nargs="*", default=None, help="per-cluster thresholds")
    p2.add_argument("--cutoffs", type=float, nargs="*", default=None)

    p3 = sub.add_parser("strobe-find-genes", help="experimental strobemer scan")
    _add_common(p3)
    p3.add_argument("--thr", type=float, default=30)
    p3.add_argument("-s", type=int, default=2)
    p3.add_argument("--w-min", type=int, default=3)
    p3.add_argument("--w-max", type=int, default=5)
    p3.add_argument("--q-prime", type=int, default=5)
    p3.add_argument("--align-score-thr", type=int, default=0)

    p4 = sub.add_parser("exact-match", help="exact occurrence search")
    p4.add_argument("--query", required=True, help="query sequence or fasta path")
    p4.add_argument("--subject", required=True, help="subject sequence or fasta path")
    p4.add_argument("--no-overlap", action="store_true")
    _add_device(p4)

    args = parser.parse_args(argv)
    # --stats re-enables INFO logging (the stats line) even under -q
    verbose = not getattr(args, "quiet", False) or getattr(args, "stats", False)
    logging.basicConfig(level=logging.INFO if verbose else logging.WARNING)

    if args.cmd == "exact-match":
        from ..ops.exact_match import exact_match

        res = exact_match(args.query, args.subject, overlap=not args.no_overlap, device=args.device)
        print(json.dumps(_jsonable(res)))
        return 0

    from .. import api

    common = {"device": args.device}
    if args.buffer is not None:
        common["buffer"] = args.buffer
    if args.gap_open is not None:
        common["gap_open_score"] = args.gap_open
    if args.gap_extend is not None:
        common["gap_extend_score"] = args.gap_extend

    try:
        if args.cmd == "find-genes":
            out = api.find_genes(
                genome_path=args.genome, ref_path=args.refs, k=args.k,
                kmer_dist_thr=args.thr, do_align=not args.no_align,
                do_return_hit_loci=True, verbose=verbose,
                devices=args.devices, checkpoint_path=args.checkpoint, **common,
            )
        elif args.cmd == "find-genes-cluster":
            kwargs = dict(common)
            if args.thr:
                kwargs["kmer_dist_thrs"] = args.thr
            if args.cutoffs:
                kwargs["cluster_cutoffs"] = args.cutoffs
            out = api.find_genes_cluster_mode(
                genome_path=args.genome, ref_path=args.refs, k=args.k,
                do_align=not args.no_align, do_return_hit_loci=True,
                verbose=verbose,
                devices=args.devices, checkpoint_path=args.checkpoint, **kwargs,
            )
        else:  # strobe-find-genes
            if args.devices:
                print("--devices is not supported for the strobemer scan", file=sys.stderr)
                return 2
            out = api.strobemer_find_genes(
                genome_path=args.genome, ref_path=args.refs,
                s=args.s, w_min=args.w_min, w_max=args.w_max, q=args.q_prime,
                kmer_dist_thr=args.thr, do_align=not args.no_align,
                align_score_thr=args.align_score_thr, do_return_hit_loci=True,
                verbose=verbose, checkpoint_path=args.checkpoint, device=args.device,
                **({"buffer": args.buffer} if args.buffer is not None else {}),
            )
    except NotImplementedError as e:
        print(f"kmergma_tpu_torch: {e}", file=sys.stderr)
        return 2

    _emit(out[0], out[1], args)
    return 0


def _jsonable(res):
    if res is None:
        return None
    if isinstance(res, str):
        return res
    if isinstance(res, dict):
        return {k: [list(r) for r in v] for k, v in res.items()}
    return [list(r) for r in res]


if __name__ == "__main__":
    raise SystemExit(main())
