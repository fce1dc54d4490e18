"""Per-record checkpoint/resume of the port's three miners, its API and its
command line, against the JAX package.

A run killed part-way (an engine that raises ``KeyboardInterrupt`` on a
given record) and then resumed from its checkpoint must return the JAX
miner's uninterrupted hits, sequences and loci exactly, scan only the
records left, and remove the file.  The file is the JAX package's, key for
key and identity string for identity string, so a checkpoint written by
either package resumes in the other: checked both ways for each miner,
with the resumed run's scanned-record count showing that it did resume
rather than start again.  tests/test_torch_host.py holds the checkpoint
module itself against the JAX package's."""

import json
import os

import numpy as np
import pytest

from kmergma_tpu.models import miner as jminer
from kmergma_tpu.models import omn_miner as jomn
from kmergma_tpu.models import strobe_miner as jstrobe
from kmergma_tpu.ops import reference as jref
from kmergma_tpu.ops.scan import ScanEngine as JaxScanEngine
from kmergma_tpu.ops.scan_cluster import ClusterScanEngine as JaxClusterScanEngine
from kmergma_tpu_torch import api as tapi
from kmergma_tpu_torch.models import miner as tminer
from kmergma_tpu_torch.models import omn_miner as tomn
from kmergma_tpu_torch.models import strobe_miner as tstrobe
from kmergma_tpu_torch.ops import reference as tref
from kmergma_tpu_torch.ops.scan import ScanEngine
from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
from kmergma_tpu_torch.utils.checkpoint import ScanCheckpoint
from kmergma_tpu_torch.utils.cli import main as cli_main
from kmergma_tpu_torch.utils.fasta import as_records

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from .test_api_golden import REFERENCE_GOLDEN_HITS

CLUSTER_THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
MINERS = ["single", "cluster", "strobe"]


class Dying:
    """An engine that raises ``KeyboardInterrupt`` when it is given record
    number ``left[0]`` (counting from 0) of a run: a run killed part-way.
    ``left`` is one list shared by every engine of the run."""

    def __init__(self, inner, left: list):
        self.inner, self.left = inner, left

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _step(self):
        if self.left[0] == 0:
            raise KeyboardInterrupt("simulated kill")
        self.left[0] -= 1

    def record_stream(self, *args, **kwargs):
        self._step()
        return self.inner.record_stream(*args, **kwargs)

    def record_streams(self, *args, **kwargs):
        self._step()
        return self.inner.record_streams(*args, **kwargs)


@pytest.fixture(scope="module")
def setup(ref_fasta):
    jclusters = jref.eliminate_null_params(jref.cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    tclusters = tref.eliminate_null_params(tref.cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    return {
        "jax": {"single": jref.gen_ref_ws_cons(ref_fasta, 6), "cluster": jclusters.profiles,
                "strobe": jstrobe.gen_strobe_ref_ws_cons(ref_fasta)},
        "port": {"single": tref.gen_ref_ws_cons(ref_fasta, 6), "cluster": tclusters.profiles,
                 "strobe": tstrobe.gen_strobe_ref_ws_cons(ref_fasta)},
    }


def _port(miner, setup, genome, ckpt=None, kill_at=None, thr=None):
    """The port's miner on the CPU; with ``kill_at``, killed on that record."""
    p = setup["port"][miner]
    left = [kill_at]
    kw = dict(get_hit_loci=True, checkpoint_path=ckpt, device="cpu")
    if miner == "single":
        engine = None if kill_at is None else Dying(
            ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, device="cpu"), left)
        return tminer.mine_genome(genome, p, thr=30 if thr is None else thr, engine=engine, **kw)
    if miner == "cluster":
        engine = None if kill_at is None else Dying(ClusterScanEngine(p, k=6, device="cpu"), left)
        return tomn.mine_genome_clusters(genome, p, thr_vec=thr or CLUSTER_THRS, buff=100, engine=engine, **kw)
    factory = None if kill_at is None else (lambda prof, x: Dying(tstrobe.StrobeSpanEngine(prof, x, device="cpu"), left))
    return tstrobe.strobe_mine_genome(genome, p, thr=30 if thr is None else thr, engine_factory=factory, **kw)


def _jax(miner, setup, genome, ckpt=None, kill_at=None, monkeypatch=None):
    """The JAX miner; with ``kill_at``, killed on that record.  Returns
    (result, records it scanned)."""
    p = setup["jax"][miner]
    left = [kill_at]
    kw = dict(get_hit_loci=True, checkpoint_path=ckpt)
    if miner == "single":
        engine = None if kill_at is None else Dying(
            JaxScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records), left)
        res = jminer.mine_genome(genome, p, thr=30, engine=engine, **kw)
        return res, res.stats.records_scanned
    if miner == "cluster":
        engine = None if kill_at is None else Dying(JaxClusterScanEngine(p, k=6), left)
        res = jomn.mine_genome_clusters(genome, p, thr_vec=CLUSTER_THRS, buff=100, engine=engine, **kw)
        return res, res.stats.records_scanned
    # the JAX strobe miner keeps no stats and takes no engine: on the CPU it
    # extracts each scanned record's strobe codes on the host once, so a
    # wrapper there counts (and kills) records
    extract, calls = jstrobe.strobe_2_mer_codes, [0]

    def counted(*args):
        if calls[0] == kill_at:
            raise KeyboardInterrupt("simulated kill")
        calls[0] += 1
        return extract(*args)

    monkeypatch.setattr(jstrobe, "strobe_2_mer_codes", counted)
    try:
        res = jstrobe.strobe_mine_genome(genome, p, thr=30, device_extract=False, **kw)
    finally:
        monkeypatch.setattr(jstrobe, "strobe_2_mer_codes", extract)
    return res, calls[0]


@pytest.fixture(scope="module")
def jax_full(setup, test_genome):
    cache = {}

    def get(miner):
        if miner not in cache:
            with pytest.MonkeyPatch.context() as mp:
                cache[miner] = _jax(miner, setup, test_genome, monkeypatch=mp)[0]
        return cache[miner]

    return get


def _same(got, want):
    assert [(h.description, h.seq) for h in got.hits] == [(h.description, h.seq) for h in want.hits]
    assert got.hit_loci == want.hit_loci
    assert len(got.hits) > 0


# --- the JAX package's own checkpoint tests, on the port ------------------


def test_checkpoint_resume(tmp_path, setup, test_genome):
    p = setup["port"]["single"]
    ckpt = tmp_path / "scan.ckpt"
    full = tminer.mine_genome(test_genome, p, thr=30, do_align=True, get_hit_loci=True, device="cpu")
    partial = tminer.mine_genome(test_genome, p, thr=30, do_align=True, get_hit_loci=True,
                                 checkpoint_path=str(ckpt), device="cpu")
    assert not ckpt.exists()  # completed runs clean up
    _same(partial, full)


def test_checkpoint_partial_restart(tmp_path, setup, test_genome):
    p = setup["port"]["single"]
    full = tminer.mine_genome(test_genome, p, thr=30, do_align=True, get_hit_loci=True, device="cpu")
    ckpt = tmp_path / "scan.ckpt"
    c = ScanCheckpoint.load_or_create(str(ckpt), f"{test_genome}|k=6|ws={p.windowsize}|thr=30")
    first = [h for h in full.hits if "JQ684648" in h.description]
    c.record_done(0, 121478, first, full.hit_loci[: len(first)])
    resumed = tminer.mine_genome(test_genome, p, thr=30, do_align=True, get_hit_loci=True,
                                 checkpoint_path=str(ckpt), device="cpu")
    _same(resumed, full)
    assert resumed.stats.records_scanned == 3


def test_cluster_miner_kill_resume(tmp_path, setup, test_genome):
    full = _port("cluster", setup, test_genome)
    ckpt = str(tmp_path / "cluster.ckpt")
    with pytest.raises(KeyboardInterrupt):
        _port("cluster", setup, test_genome, ckpt, kill_at=2)
    assert os.path.exists(ckpt)  # partial progress persisted
    resumed = _port("cluster", setup, test_genome, ckpt)
    _same(resumed, full)
    assert not os.path.exists(ckpt)


def test_find_genes_checkpoint_api(tmp_path, mini_genome, ref_fasta):
    ckpt = str(tmp_path / "fg.ckpt")
    hits = tapi.find_genes(genome_path=mini_genome, ref_path=ref_fasta, verbose=False, checkpoint_path=ckpt,
                           device="cpu")[0]
    assert [h.description for h in hits] == REFERENCE_GOLDEN_HITS
    assert not os.path.exists(ckpt)


def test_strobe_miner_checkpoint_resume(tmp_path, setup, test_genome):
    p = setup["port"]["strobe"]
    full = tstrobe.strobe_mine_genome(test_genome, p, thr=30, do_align=False, get_hit_loci=True, device="cpu")
    ckpt = str(tmp_path / "strobe.ckpt")
    ck = ScanCheckpoint.load_or_create(ckpt, f"strobe|{test_genome}|s=2|wmin=3|wmax=5|q=5|ws={p.windowsize}|thr=30")
    recs = as_records(test_genome)
    done = [h for h in full.hits if h.description.startswith(recs[0].identifier)]
    ck.record_done(0, len(recs[0]), done, full.hit_loci[: len(done)])
    resumed = tstrobe.strobe_mine_genome(test_genome, p, thr=30, do_align=False, get_hit_loci=True,
                                         checkpoint_path=ckpt, device="cpu")
    _same(resumed, full)
    assert resumed.stats.records_scanned == 3
    assert not os.path.exists(ckpt)


# --- kill and resume, against the JAX miner's uninterrupted run --------------


@pytest.mark.parametrize("miner", MINERS)
def test_kill_resume_equals_jax(miner, tmp_path, setup, test_genome, jax_full):
    ckpt = str(tmp_path / f"{miner}.ckpt")
    with pytest.raises(KeyboardInterrupt):
        _port(miner, setup, test_genome, ckpt, kill_at=2)
    with open(ckpt) as fh:
        state = json.load(fh)
    assert state["next_record"] == 2
    resumed = _port(miner, setup, test_genome, ckpt)
    _same(resumed, jax_full(miner))
    assert resumed.stats.records_scanned == 2
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("miner", MINERS)
def test_cross_package_resume(miner, direction, tmp_path, setup, test_genome, jax_full, monkeypatch):
    """A run of one package killed after record 0 resumes in the other."""
    ckpt = str(tmp_path / f"{miner}.ckpt")
    with pytest.raises(KeyboardInterrupt):
        if direction == "jax_to_port":
            _jax(miner, setup, test_genome, ckpt, kill_at=1, monkeypatch=monkeypatch)
        else:
            _port(miner, setup, test_genome, ckpt, kill_at=1)
    with open(ckpt) as fh:
        assert json.load(fh)["next_record"] == 1
    if direction == "jax_to_port":
        resumed = _port(miner, setup, test_genome, ckpt)
        scanned = resumed.stats.records_scanned
    else:
        resumed, scanned = _jax(miner, setup, test_genome, ckpt, monkeypatch=monkeypatch)
    _same(resumed, jax_full(miner))
    assert scanned == 3  # it resumed: the identity strings agree
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("miner", MINERS)
def test_short_record_between_scanned_records(miner, tmp_path, setup, mini_genome, monkeypatch):
    """A record too short to scan between two scanned ones is skipped and
    counted in ``records_skipped``; it advances ``GenomePos`` in cluster
    mode only, as in the JAX miners.  The hits, loci and the ``GenomePos``
    in their descriptions equal the JAX miner's, uninterrupted and resumed
    from a checkpoint written after the skip."""
    locus = as_records(mini_genome)[0]
    genome = str(tmp_path / "short_between.fasta")
    with open(genome, "w") as fh:
        for name, seq in (("first", locus.seq), ("short", locus.seq[:100]), ("second", locus.seq)):
            fh.write(f">{name}\n{seq.decode()}\n")
    want, scanned = _jax(miner, setup, genome, monkeypatch=monkeypatch)
    got = _port(miner, setup, genome)
    _same(got, want)
    assert scanned == got.stats.records_scanned == 2 and got.stats.records_skipped == 1
    if miner != "strobe":  # the JAX strobe miner keeps no stats
        assert want.stats.records_skipped == 1
    genome_pos = len(locus) + (100 if miner == "cluster" else 0)
    second = [h.description for h in got.hits if h.description.startswith("second ")]
    assert second and all(f" | GenomePos = {genome_pos} | " in d for d in second)
    ckpt = str(tmp_path / f"{miner}.ckpt")
    with pytest.raises(KeyboardInterrupt):
        _port(miner, setup, genome, ckpt, kill_at=1)
    with open(ckpt) as fh:
        state = json.load(fh)
    assert (state["next_record"], state["genome_pos"]) == (2, genome_pos)
    resumed = _port(miner, setup, genome, ckpt)
    _same(resumed, want)
    assert (resumed.stats.records_scanned, resumed.stats.records_skipped) == (1, 0)


@pytest.mark.parametrize("miner", MINERS)
def test_stale_identity_is_ignored(miner, tmp_path, setup, test_genome, jax_full):
    """A checkpoint of a run with another threshold is not resumed: the
    run starts afresh and rewrites it."""
    ckpt = str(tmp_path / f"{miner}.ckpt")
    thr = [t + 1 for t in CLUSTER_THRS] if miner == "cluster" else 31
    with pytest.raises(KeyboardInterrupt):
        _port(miner, setup, test_genome, ckpt, kill_at=2, thr=thr)
    resumed = _port(miner, setup, test_genome, ckpt)
    _same(resumed, jax_full(miner))
    assert resumed.stats.records_scanned == 4
    assert not os.path.exists(ckpt)


def test_file_keys_and_identity_match_jax(tmp_path, setup, test_genome, monkeypatch):
    """The port writes the JAX writer's keys, in its order, and the same
    identity string for the same run; a NumPy threshold prints as the
    float it is."""
    for miner in MINERS:
        files = {}
        for pkg in ("port", "jax"):
            path = str(tmp_path / f"{miner}.{pkg}.ckpt")
            with pytest.raises(KeyboardInterrupt):
                if pkg == "port":
                    _port(miner, setup, test_genome, path, kill_at=1)
                else:
                    _jax(miner, setup, test_genome, path, kill_at=1, monkeypatch=monkeypatch)
            with open(path) as fh:
                files[pkg] = json.load(fh)
        assert list(files["port"]) == list(files["jax"])
        assert files["port"] == files["jax"], miner
    path = str(tmp_path / "np.ckpt")
    with pytest.raises(KeyboardInterrupt):
        _port("single", setup, test_genome, path, kill_at=1, thr=np.float64(30.0))
    with open(path) as fh:
        assert json.load(fh)["genome_id"] == f"{test_genome}|k=6|ws={setup['port']['single'].windowsize}|thr=30.0"


# --- through the API and the command line ------------------------------------


_API = {"single": "find_genes", "cluster": "find_genes_cluster_mode", "strobe": "strobemer_find_genes"}
_CMD = {"single": "find-genes", "cluster": "find-genes-cluster", "strobe": "strobe-find-genes"}


@pytest.fixture(scope="module")
def jax_api(test_genome, ref_fasta):
    from kmergma_tpu import api as japi

    cache = {}

    def get(miner):
        if miner not in cache:
            cache[miner] = getattr(japi, _API[miner])(test_genome, ref_fasta, verbose=False, do_return_hit_loci=True)
        return cache[miner]

    return get


def _kill_default_engines(monkeypatch, kill_at: int) -> None:
    """Make the port's default engines die on record ``kill_at`` of the next run."""
    left = [kill_at]
    make_single, make_cluster, make_strobe = tminer._default_engine, tomn.ClusterScanEngine, tstrobe.StrobeSpanEngine
    monkeypatch.setattr(tminer, "_default_engine", lambda *a, **kw: Dying(make_single(*a, **kw), left))
    monkeypatch.setattr(tomn, "ClusterScanEngine", lambda *a, **kw: Dying(make_cluster(*a, **kw), left))
    monkeypatch.setattr(tstrobe, "StrobeSpanEngine", lambda *a, **kw: Dying(make_strobe(*a, **kw), left))


@pytest.mark.parametrize("miner", MINERS)
def test_api_kill_resume_equals_jax(miner, tmp_path, monkeypatch, test_genome, ref_fasta, jax_api):
    ckpt = str(tmp_path / f"{miner}.ckpt")
    call = getattr(tapi, _API[miner])
    kw = dict(verbose=False, do_return_hit_loci=True, checkpoint_path=ckpt, device="cpu")
    with monkeypatch.context() as mp:
        _kill_default_engines(mp, 2)
        with pytest.raises(KeyboardInterrupt):
            call(test_genome, ref_fasta, **kw)
    with open(ckpt) as fh:
        assert json.load(fh)["next_record"] == 2
    hits, loci = call(test_genome, ref_fasta, **kw)
    want_hits, want_loci = jax_api(miner)
    assert [(h.description, h.seq) for h in hits] == [(h.description, h.seq) for h in want_hits]
    assert loci == want_loci and len(hits) > 0
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("miner", MINERS)
def test_cli_checkpoint_kill_resume(miner, tmp_path, monkeypatch, capsys, test_genome, ref_fasta, jax_api):
    ckpt = str(tmp_path / f"{miner}.ckpt")
    argv = [_CMD[miner], "--genome", test_genome, "--refs", ref_fasta, "--quiet", "--hit-loci",
            "--device", "cpu", "--checkpoint", ckpt]
    with monkeypatch.context() as mp:
        _kill_default_engines(mp, 2)
        with pytest.raises(KeyboardInterrupt):
            cli_main(argv)
    assert os.path.exists(ckpt)
    capsys.readouterr()
    assert cli_main(argv) == 0
    out = capsys.readouterr()
    want_hits, want_loci = jax_api(miner)
    assert out.out == "".join(f">{h.description}\n{h.seq_str()}\n" for h in want_hits)
    assert json.loads(out.err.strip().splitlines()[-1]) == {"hit_loci": want_loci}
    assert not os.path.exists(ckpt)
