"""parallel.launch.run_ranks's device: the card by default, as every entry
point of the port, and a refusal before any rank starts where torch finds
no CUDA device (this test forces that case whatever the machine has)."""
import subprocess

import pytest
import torch

from thallo_tpu_torch.parallel import launch


def _never_started(*args, **kwargs):
    raise AssertionError("run_ranks started a rank")


def _job():
    return 0


def test_run_ranks_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "Popen", _never_started)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_ranks(_job, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_ranks(_job, 2, device="cuda")


def test_run_ranks_refuses_an_unknown_device(monkeypatch):
    monkeypatch.setattr(subprocess, "Popen", _never_started)
    with pytest.raises(ValueError, match="device must be"):
        launch.run_ranks(_job, 2, device="tpu")
