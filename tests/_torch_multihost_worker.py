"""Worker of the two-process sharded scan tests (tests/test_torch_parallel.py
and tests/test_torch_tp.py on the CPU, tests/test_torch_multicard.py on the
cards).

    python tests/_torch_multihost_worker.py <port> <process id> <processes> [cpu|cuda] [sharded|tp|two_axis]

Joins a process group on localhost (gloo for ``cpu``, the default; NCCL
for ``cuda``) and builds the mesh over every process (two logical CPU
shards each, or each process's own card, ``LOCAL_RANK``; processes
outermost on the data axis).  Mode ``sharded`` (the default) holds the
sharded single-profile and cluster engines' streams, one pass and segment
batches, bit-identical to the one-device engines' on the same record;
mode ``tp`` holds ``TPScanEngine``'s streams, its table sharded over the
processes, and the miner's own route to it at k = 10; mode ``two_axis``
holds ``sharded_cluster_scan_step`` on a hybrid mesh with two clusters
ways (two logical shards of each process's device, the data axis across
the processes) to one device's outputs.  Imports only the port.
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REF = str(Path(__file__).resolve().parent / "data" / "Alp_V_ref.fasta")


def run_workers(kind: str, nproc: int = 2, timeout: float = 240, mode: str = "sharded") -> None:
    """Run ``nproc`` workers of ``kind`` in ``mode`` on a free localhost
    port, each with its ``LOCAL_RANK``; fail unless every one of them
    passes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen([sys.executable, __file__, str(port), str(pid), str(nproc), kind, mode],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1", "LOCAL_RANK": str(pid)})
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert f"two-process {mode} streams bit-identical OK" in out


def sharded_checks(mesh, dev, pid: int) -> None:
    """The sharded single-profile and cluster engines against one device's."""
    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.ops.scan_host import scan_window_distances_np_i64
    from kmergma_tpu_torch.parallel.sharded_scan import ShardedClusterScanEngine, ShardedScanEngine
    from kmergma_tpu_torch.utils.checkpoint import ScanCheckpoint
    from kmergma_tpu_torch.utils.fasta import as_records

    rng = np.random.default_rng(3)
    n, k, ws, r = 30_000, 6, 289, 9
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int32)
    single = ScanEngine(s, k=k, ws=ws, r=r, device=dev)
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = float(np.percentile(d / single.scale, 5))
    want = single.record_stream(codes, thr)
    sharded = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=mesh, chunk_windows=2048)
    assert sharded.record_stream(codes, thr)[:2] == want[:2] and len(want[1]) > 0
    with tempfile.TemporaryDirectory() as tmp:  # segment batches: the shards x 4 spans x 1024 windows
        small = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=mesh, chunk_windows=1024)
        ckpt = ScanCheckpoint.load_or_create(str(Path(tmp) / f"p{pid}.ckpt"), "g")
        assert small.record_stream(codes, thr, seg_tracker=ckpt.segment_tracker(0))[:2] == want[:2]
        assert ckpt.seg_next >= 2

    clusters = eliminate_null_params(cluster_ref_api(REF, 6, cutoffs=[7, 12, 20, 25]))
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    genes = [rec.codes for rec in as_records(REF)]
    ccodes = codes.copy()
    for j, pos in enumerate(range(1_000, n - 1_000, 4_000)):
        ccodes[pos : pos + genes[j].shape[0]] = genes[j]
    cwant = ClusterScanEngine(clusters.profiles, k=6, device=dev).record_streams(ccodes, thrs)
    cgot = ShardedClusterScanEngine(clusters.profiles, k=6, mesh=mesh, chunk_windows=2048).record_streams(ccodes, thrs)
    assert cgot == cwant and any(len(st) for _, st in cwant)


def tp_checks(mesh, dev) -> None:
    """TPScanEngine over the processes' shards against one device's
    engine, at k = 10, and the miner's own route to it."""
    from kmergma_tpu_torch.models.miner import _default_engine, mine_genome
    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons
    from kmergma_tpu_torch.ops.scan import ScanEngine
    from kmergma_tpu_torch.parallel.tp_lookup import TPScanEngine
    from kmergma_tpu_torch.utils.fasta import as_records

    profile = gen_ref_ws_cons(REF, 10)
    k, ws, r = 10, profile.windowsize, profile.n_records
    genome = str(Path(REF).with_name("Alp_V_locus.fasta"))
    codes = as_records(genome)[0].codes
    single = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, device=dev)
    tp = TPScanEngine(profile.sum_kfv, k=k, ws=ws, r=r, mesh=mesh, chunk_windows=8192)
    assert tp.shard_bytes == 4 * 4**k // mesh.shape["data"]
    for thr in (8.0, 12.0):
        want = single.record_stream(codes, thr)
        assert tp.record_stream(codes, thr)[:2] == want[:2] and len(want[1]) > 0
    routed = _default_engine(profile, dev)
    assert isinstance(routed, TPScanEngine) and routed.mesh.distributed, type(routed)
    got = mine_genome(genome, profile, thr=12.0, device=dev)
    want = mine_genome(genome, profile, thr=12.0, engine=single, device=dev)
    assert [h.description for h in got.hits] == [h.description for h in want.hits] and len(want.hits) == 2


def two_axis_checks(dev) -> None:
    """The two-axis step on a hybrid (clusters 2 x data 2) mesh against
    the step on this process's device alone, on the same inputs in every
    process."""
    from kmergma_tpu_torch.ops.scan_host import scan_window_distances_np_i64
    from kmergma_tpu_torch.parallel.mesh import Mesh, make_hybrid_mesh
    from kmergma_tpu_torch.parallel.sharded_scan import make_tiles, sharded_cluster_scan_step

    rng = np.random.default_rng(5)
    k, ws, r, cap, t = 6, 64, 4, 16, 32
    codes = rng.integers(0, 4, 9 * t + ws + 10, dtype=np.int8)
    s = rng.integers(0, 8, (4, 4**k)).astype(np.int32)
    thr = np.array([np.percentile(scan_window_distances_np_i64(codes, p, k, ws, r), 10) for p in s], dtype=np.int32)
    mesh = make_hybrid_mesh(n_clusters=2, devices=[dev, dev])
    assert mesh.shape == {"clusters": 2, "data": 2} and mesh.distributed, mesh.shape
    tiles, _ = make_tiles(codes, t, ws, mesh.shape["data"])
    got = sharded_cluster_scan_step(tiles, s, thr, k=k, ws=ws, r=r, cap=cap, mesh=mesh)
    want = sharded_cluster_scan_step(tiles, s, thr, k=k, ws=ws, r=r, cap=cap, mesh=Mesh((dev,)))
    assert all(a.device == dev and a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[1].sum()) > 0 and got[0].shape == (4, tiles.shape[0])


def main() -> None:
    port, pid, nproc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    kind = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    mode = sys.argv[5] if len(sys.argv) > 5 else "sharded"
    torch.set_num_threads(1)

    from kmergma_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid, device=kind)
    if kind == "cuda":
        mesh = make_mesh()
        assert mesh.local_data == [torch.device("cuda", pid)] == [torch.device("cuda", torch.cuda.current_device())]
    else:
        mesh = make_mesh(devices=["cpu", "cpu"])
    dev = mesh.first
    assert mesh.distributed and mesh.shape["data"] == len(mesh.local_data) * nproc, mesh.shape
    assert mesh.process_index == pid

    if mode == "tp":
        tp_checks(mesh, dev)
    elif mode == "two_axis":
        two_axis_checks(dev)
    else:
        sharded_checks(mesh, dev, pid)

    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"proc {pid} ({dev}): two-process {mode} streams bit-identical OK", flush=True)


if __name__ == "__main__":
    main()
