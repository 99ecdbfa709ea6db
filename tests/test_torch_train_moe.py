"""Training of the MoE and hybrid families against the JAX package, on the
CPU: moonshot-v1-16b-a3b (MoE) and jamba-v0.1-52b (hybrid: mamba,
attention and MoE layers) at their smoke configs, through the helpers and
at the tolerances of ``test_torch_train_families.py``: the Hapi step on
both of its paths, the baseline step and ``run_training``."""
import pytest

from test_torch_train import _compare_steps
from test_torch_train_families import _baseline, _hapi, _loss_falls

MOE_HYBRID = ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", MOE_HYBRID)
@pytest.mark.parametrize("micro,cos", [(4, 2), (2, 4)], ids=["fused", "coarse"])
def test_hapi_step_matches_jax(arch, micro, cos):
    """Fused (extract a chunk of 2, grad, accumulate) and coarse (extract at
    4, grads over chunks of 2)."""
    _compare_steps(*_hapi(arch, micro, cos))


@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_baseline_step_matches_jax(arch):
    _baseline(arch)


@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_run_training_loss_falls(arch):
    _loss_falls(arch)
