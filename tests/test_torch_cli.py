"""The port's command line (``python -m kmergma_tpu_torch``) against the
JAX package's (``python -m kmergma_tpu``): each subcommand with
``--device cpu`` prints what the JAX CLI prints on Alp_V_locus, and the
option not ported yet (``--devices``) exits with status 2 and the API's
message.  ``--checkpoint`` is in tests/test_torch_checkpoint.py."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kmergma_tpu.utils.cli import main as jax_main
from kmergma_tpu_torch.utils.cli import main

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _stdout(fn, argv, capsys):
    capsys.readouterr()
    assert fn(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["find-genes", "--quiet"],
    ["find-genes", "--quiet", "--no-align", "--thr", "30"],
    ["find-genes-cluster", "--quiet"],
    ["strobe-find-genes", "--quiet"],
])
def test_scan_subcommands_print_the_jax_hits(argv, capsys, mini_genome, ref_fasta):
    args = [*argv, "--genome", mini_genome, "--refs", ref_fasta]
    got = _stdout(main, [*args, "--device", "cpu"], capsys)
    want = _stdout(jax_main, args, capsys)
    assert got == want and got.count(">") >= 3


def test_exact_match_subcommand(capsys, ref_fasta):
    for args in (["--query", "GAG", "--subject", "CGAGAGAGAAGGCCGAGCTTTT", "--no-overlap"],
                 ["--query", "AAATT", "--subject", ref_fasta]):
        got = _stdout(main, ["exact-match", *args, "--device", "cpu"], capsys)
        assert got == _stdout(jax_main, ["exact-match", *args], capsys)
    assert json.loads(got) == {"AM773729|IGHV1-1*01|Vicugna": [[174, 178]], "AM939700|IGHV1S5*01|Vicugna": [[174, 178]]}


def test_output_file_and_hit_loci(tmp_path, capsys, mini_genome, ref_fasta):
    out = tmp_path / "hits.fasta"
    rc = main(["find-genes", "--genome", mini_genome, "--refs", ref_fasta, "-o", str(out), "--quiet",
               "--hit-loci", "--device", "cpu"])
    assert rc == 0
    assert out.read_text().count(">") == 3
    assert json.loads(capsys.readouterr().err.strip().splitlines()[-1]) == {"hit_loci": [6852, 23907, 33845]}


@pytest.mark.parametrize("flag,item", [(["--devices", "2"], "Queue 1 item 2")])
@pytest.mark.parametrize("cmd", ["find-genes", "find-genes-cluster"])
def test_unported_options_exit_2(cmd, flag, item, capsys, mini_genome, ref_fasta):
    rc = main([cmd, "--genome", mini_genome, "--refs", ref_fasta, "--quiet", "--device", "cpu", *flag])
    assert rc == 2
    assert item in capsys.readouterr().err


def test_module_entry_point_refuses_without_cuda(mini_genome, ref_fasta):
    """``python -m kmergma_tpu_torch`` runs on the card by default: here,
    without CUDA, it fails instead of going on on the CPU."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "kmergma_tpu_torch", "find-genes", "--genome", mini_genome, "--refs", ref_fasta, "-q"],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see tests/_torch_one_thread.py
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
