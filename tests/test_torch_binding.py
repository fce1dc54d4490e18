"""Positional arguments bind on the port as on the JAX package.

Every class and function that a JAX module defines and its same-named port
module also has is a pair.  A call written for the JAX package, with its
arguments by position, must bind each of them to the same parameter on the
port, up to the first JAX parameter that the port leaves out on purpose
(``use_pallas``, ``use_fused``, ``pair_kernel``, the bitmap kernels'
packed ``meta``); past that point it binds
the same way or raises ``TypeError``, and never lands silently on another
parameter.  The port's own parameters (``device``, ``devices``, ``cache``,
``engine_factory``) are keyword-only, so no JAX-style call reaches them.

The engines' concrete cases run both packages on the CPU: a JAX-style
``chunk_windows`` by position gives the JAX engine's streams, and a
positional ``use_pallas`` is refused."""

import importlib
import inspect
from pathlib import Path

import pytest

from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops import scan_cluster as jcluster
from kmergma_tpu.parallel import sharded_scan as jsharded
from kmergma_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops import scan_cluster as tcluster
from kmergma_tpu_torch.parallel import sharded_scan as tsharded
from kmergma_tpu_torch.parallel.mesh import make_mesh

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_engine import _planted
from .test_torch_engine_options import CLUSTER_THRS, _same_streams, clusters, locus  # noqa: F401 (fixtures)

ROOT = Path(__file__).resolve().parent.parent
#: the JAX parameters the port leaves out on purpose (ROADMAP.md): the
#: engines' Pallas and fusion switches, and ``meta``, the int32 scalars
#: (thr, l0, nw) that the Pallas bitmap kernels take packed in one operand,
#: which K1's and K3's wrappers take as the keywords ``thr``, ``l0``, ``nw``
LEFT_OUT = {"use_pallas", "use_fused", "pair_kernel", "meta"}
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _pairs() -> dict:
    """``{"ops.scan.ScanEngine": (jax callable, port callable), ...}``: each
    class or function defined in a JAX module whose port module has the
    same name."""
    pairs = {}
    for path in sorted((ROOT / "kmergma_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "kmergma_tpu").with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        if parts[-1:] == ["__main__"]:
            continue
        jname = ".".join(["kmergma_tpu", *parts])
        try:
            pmod = importlib.import_module(".".join(["kmergma_tpu_torch", *parts]))
        except ModuleNotFoundError:
            continue  # scan_pallas: its kernels live in csrc/ and scan_kernels
        jmod = importlib.import_module(jname)
        for name, obj in vars(jmod).items():
            # functions, classes and jitted functions (``jax.jit`` keeps the
            # wrapped function's module and signature)
            if callable(obj) and getattr(obj, "__module__", None) == jname and hasattr(pmod, name):
                pairs[".".join([*parts, name])] = (obj, getattr(pmod, name))
    return pairs


PAIRS = _pairs()
PUBLIC = sorted(n for n in PAIRS if not n.rsplit(".", 1)[-1].startswith("_"))
ENGINES = ["ops.scan.ScanEngine", "ops.scan_cluster.ClusterScanEngine", "parallel.sharded_scan.ShardedScanEngine",
           "parallel.sharded_scan.ShardedClusterScanEngine", "parallel.tp_lookup.TPScanEngine",
           "models.strobe_miner.StrobeSpanEngine"]


def test_the_audit_pairs_the_engines_and_the_api():
    """The pairing finds the six engines, the three API calls, the miners
    and the mesh, so the parametrised cases below cover them."""
    for name in [*ENGINES, "api.find_genes", "api.find_genes_cluster_mode", "api.strobemer_find_genes",
                 "models.miner.mine_genome", "models.omn_miner.mine_genome_clusters",
                 "models.strobe_miner.strobe_mine_genome", "ops.exact_match.exact_match",
                 "parallel.mesh.make_mesh", "parallel.sharded_scan.sharded_cluster_scan_step"]:
        assert name in PUBLIC, name
    assert len(PUBLIC) > 100


class _Arg:
    """A positional argument that names its place."""

    def __init__(self, i: int):
        self.i = i

    def __repr__(self) -> str:
        return f"arg{self.i}"


@pytest.mark.parametrize("name", PUBLIC)
def test_positional_arguments_bind_as_in_jax(name):
    """For each prefix of the JAX call's positional parameters, the same
    arguments bind to the same names on the port; past the first parameter
    left out on purpose the port may raise ``TypeError`` instead."""
    jfn, pfn = PAIRS[name]
    want_sig, got_sig = inspect.signature(jfn), inspect.signature(pfn)
    jpos = [p.name for p in want_sig.parameters.values() if p.kind in _POSITIONAL]
    agree = next((i for i, p in enumerate(jpos) if p in LEFT_OUT), len(jpos))
    args = [_Arg(i) for i in range(len(jpos))]
    for n in range(len(jpos) + 1):
        want = dict(want_sig.bind_partial(*args[:n]).arguments)
        if n > agree:
            try:
                got = dict(got_sig.bind_partial(*args[:n]).arguments)
            except TypeError:
                continue
        else:
            got = dict(got_sig.bind_partial(*args[:n]).arguments)
        assert got == want, (name, n)


@pytest.mark.parametrize("name", PUBLIC)
def test_port_only_parameters_are_keyword_only(name):
    """A parameter that the JAX callable does not have is keyword-only on
    the port, so a positional argument never reaches it."""
    jfn, pfn = PAIRS[name]
    jparams = inspect.signature(jfn).parameters
    for p in inspect.signature(pfn).parameters.values():
        if p.name not in jparams:
            assert p.kind in (inspect.Parameter.KEYWORD_ONLY, inspect.Parameter.VAR_KEYWORD), (name, p.name)


# --- the engines, built JAX-style on the CPU ---------------------------------


def test_scan_engine_chunk_windows_by_position_matches_jax():
    """``ScanEngine(S, k, ws, r, 4096, device="cpu")`` takes 4096 as
    ``chunk_windows`` (before, 4096 bound to ``device``), so a seeded
    30 kb record takes the segmented path, and its stream equals the JAX
    ``ScanEngine(S, k, ws, r, 4096)``'s."""
    k, ws, r = 6, 240, 5
    s, codes = _planted(18, n=30_000, k=k, ws=ws, r=r)
    port = tscan.ScanEngine(s, k, ws, r, 4096, device="cpu")
    jeng = jscan.ScanEngine(s, k, ws, r, 4096)
    jeng.full_fetch_windows = 0
    assert port.chunk == jeng.chunk == 4096 and port.bound_depth == 16
    assert codes.shape[0] - ws + 1 > 2 * port.chunk  # segmented
    d0, stream, _ = port.record_stream(codes, 22.0)
    w0, want, _ = jeng.record_stream(codes, 22.0)
    assert d0 == w0 and stream == want
    assert min(p for p, _d in want) < 2 * port.chunk < max(p for p, _d in want)  # runs in both segments


def test_cluster_engine_chunk_windows_by_position_matches_jax(clusters, locus):
    """``ClusterScanEngine(profiles, 6, 1 << 18, device="cpu")`` takes the
    third argument as ``chunk_windows``, as the JAX engine does, and its
    streams on the Alp_V locus equal the JAX engine's."""
    port = tcluster.ClusterScanEngine(clusters.profiles, 6, 1 << 18, device="cpu")
    jeng = jcluster.ClusterScanEngine(clusters.profiles, 6, 1 << 18, use_fused=False)
    jeng.engines[0].full_fetch_windows = 0
    assert port.chunk == jeng.chunk == 1 << 18 and port.device.type == "cpu"
    _same_streams(port.record_streams(locus, CLUSTER_THRS), jeng.record_streams(locus, CLUSTER_THRS))


def test_sharded_engines_chunk_windows_by_position(clusters, locus):
    """The sharded engines take ``mesh`` and ``chunk_windows`` by position
    as the JAX ones do, and scan as the one-device engines."""
    mesh = make_mesh(2, device="cpu")
    s, codes = _planted(19, n=20_000)
    sh = tsharded.ShardedScanEngine(s, 6, 240, 5, mesh, 2048)
    assert sh.chunk == 2048 and sh.mesh is mesh and sh.bound_depth == 16
    want = tscan.ScanEngine(s, 6, 240, 5, device="cpu").record_stream(codes, 22.0)[:2]
    assert sh.record_stream(codes, 22.0)[:2] == want and want[1]
    csh = tsharded.ShardedClusterScanEngine(clusters.profiles, 6, mesh, 4096)
    assert csh.chunk == 4096 and csh.mesh is mesh and csh.shared_depth == 16
    cwant = tcluster.ClusterScanEngine(clusters.profiles, 6, device="cpu").record_streams(locus, CLUSTER_THRS)
    _same_streams(csh.record_streams(locus, CLUSTER_THRS), cwant)


@pytest.mark.parametrize("call", ["ScanEngine", "ShardedScanEngine", "ClusterScanEngine", "ShardedClusterScanEngine"])
def test_positional_use_pallas_raises(clusters, call):
    """``use_pallas`` by position, as a JAX call writes it, raises
    ``TypeError`` on the port, where before ``ShardedScanEngine(S, k, ws,
    r, mesh, None, False)`` bound ``False`` to ``bound_depth`` without an
    error.  The JAX engines build from the same calls."""
    s, _codes = _planted(20, n=2_000)

    def args(mesh) -> tuple:
        return {"ScanEngine": (s, 6, 240, 5, None, False),
                "ShardedScanEngine": (s, 6, 240, 5, mesh, None, False),
                "ClusterScanEngine": (clusters.profiles, 6, None, False),
                "ShardedClusterScanEngine": (clusters.profiles, 6, mesh, None, False)}[call]

    jax_mod = {"ScanEngine": jscan, "ClusterScanEngine": jcluster}.get(call, jsharded)
    port_mod = {"ScanEngine": tscan, "ClusterScanEngine": tcluster}.get(call, tsharded)
    jeng = getattr(jax_mod, call)(*args(jax_make_mesh(2)))
    assert jeng.chunk > 0 and getattr(jeng, "bound_depth", 16) == 16
    with pytest.raises(TypeError):
        getattr(port_mod, call)(*args(make_mesh(2, device="cpu")))
