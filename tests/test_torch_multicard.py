"""The sharded scan across processes on the cards: two processes joined by
NCCL, each driving its own card (``LOCAL_RANK``), give the streams of one
card, and the two-axis step on a hybrid mesh (two clusters ways on each
card) one card's outputs (tests/_torch_multihost_worker.py).  It needs two CUDA devices and
imports only the port, so it runs on a GPU host without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_multicard.py
"""

import pytest
import torch

from ._torch_multihost_worker import run_workers


@pytest.mark.cuda
def test_two_process_nccl_sharded_scan():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    run_workers("cuda", timeout=600)


@pytest.mark.cuda
def test_two_process_nccl_two_axis_step():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    run_workers("cuda", timeout=600, mode="two_axis")
