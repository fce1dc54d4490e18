"""The port's command line (``python -m kmergma_tpu_torch``) against the
JAX package's (``python -m kmergma_tpu``): each subcommand with
``--device cpu`` prints what the JAX CLI prints on Alp_V_locus;
``--devices N`` shards the two scan subcommands (N logical shards with
``--device cpu``) and exits with status 2 and the API's message when fewer
than N cards are present; the strobemer subcommand refuses it, as the JAX
CLI does.  ``--checkpoint`` is in tests/test_torch_checkpoint.py."""

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


@pytest.mark.parametrize("flag,item", [(["--devices", "2"], "2 CUDA devices requested, 1 present")])
@pytest.mark.parametrize("cmd", ["find-genes", "find-genes-cluster"])
def test_unported_options_exit_2(cmd, flag, item, capsys, mini_genome, ref_fasta, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # one card, two asked for
    rc = main([cmd, "--genome", mini_genome, "--refs", ref_fasta, "--quiet", *flag])
    assert rc == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["find-genes", "find-genes-cluster"])
def test_devices_shards_on_cpu(cmd, capsys, mini_genome, ref_fasta):
    """``--devices 3 --device cpu``: three logical CPU shards print the
    one-device hits and loci."""
    args = [cmd, "--genome", mini_genome, "--refs", ref_fasta, "--quiet", "--hit-loci", "--device", "cpu"]
    assert main(args) == 0
    want = capsys.readouterr()
    assert main([*args, "--devices", "3"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.out.count(">") == 3
    assert got.err.strip().splitlines()[-1] == want.err.strip().splitlines()[-1]


def test_strobe_refuses_devices(capsys, mini_genome, ref_fasta):
    rc = main(["strobe-find-genes", "--genome", mini_genome, "--refs", ref_fasta, "--quiet", "--device", "cpu",
               "--devices", "2"])
    assert rc == 2
    assert "--devices is not supported for the strobemer scan" in capsys.readouterr().err


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
