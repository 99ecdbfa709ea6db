"""The sharded train step of the SSM and encoder-decoder families on 4 gloo
ranks: ``tests/test_torch_sharded_step.py``'s check on mamba2-1.3b (its SSM
heads over the model axis, B and C replicated, through the SSD scan's
``local_map``) and whisper-small (the encoder's and decoder's heads over the
model axis, the cross-attention on DTensors), each a (2, 2) mesh of spawned
ranks against the one-device port step within 1e-5.
"""
import pytest
import torch

from test_torch_sharded_step import JOIN_S, _sharded_rank, check_sharded

ARCHS = ("mamba2-1.3b", "whisper-small")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    from test_torch_distributed_extras import _spawn
    d = tmp_path_factory.mktemp("sharded_ssm")
    _spawn(_sharded_rank, 4, (str(d / "store"), str(d / "out.pt"), ARCHS), join_s=JOIN_S)
    return torch.load(d / "out.pt")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_on_four_gloo_ranks_equals_the_one_device_step(sharded, arch):
    check_sharded(sharded[arch], arch)
