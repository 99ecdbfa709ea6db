"""The rest of the port's planner against the JAX package's, on the CPU.

``profile_layered`` of the four paper vision models, ``choose_split`` and
``choose_split_cost_optimal`` on their profiles, the §4 cost model
(``core/cost_model.py``), ``calibrate_profile`` and
``extrapolation_error``. The planner is arithmetic on shapes, so the port
must give the reference's numbers: bytes exactly, FLOPs to 1e-12 relative,
the same decisions. The cost model's HBM rates default to each package's own
hardware (an H100 in the port), so the comparisons pass one rate to both.
"""
import dataclasses
import functools
import inspect

import numpy as np
import pytest

from repro.config import HapiConfig as JHapi
from repro.core import cost_model as jcm
from repro.core import profiler as jprof
from repro.core import splitter as jspl
from repro.models import vision as jv
from repro_torch.config import HW, HapiConfig
from repro_torch.core import cost_model as tcm
from repro_torch.core import profiler as tprof
from repro_torch.core import splitter as tspl
from repro_torch.models import vision as tv

MODELS = ["alexnet", "resnet18", "vgg11", "transformer"]
FLOPS_RTOL = 1e-12
TPU_HBM = 819e9                   # the reference's own default rate


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@functools.lru_cache(maxsize=None)
def _profiles(name, num_classes=1000):
    """(JAX profile, the port's profile of the same model on meta tensors)."""
    return (jprof.profile_layered(jv.PAPER_MODELS[name](num_classes)),
            tprof.profile_layered(tv.PAPER_MODELS[name](num_classes, device="meta")))


def _same_profile(got, want):
    g, w = _fields(got), _fields(want)
    flops_g, flops_w = g.pop("cum_flops"), w.pop("cum_flops")
    assert g == w
    np.testing.assert_allclose(flops_g, flops_w, rtol=FLOPS_RTOL, atol=0)


# ---------------------------------------------------------------------------
# profile_layered
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_profile_layered_matches_jax(name):
    j, t = _profiles(name)
    _same_profile(t, j)
    assert t.total_flops == pytest.approx(j.total_flops, rel=FLOPS_RTOL)
    for b in (0, 1, t.freeze_index, t.n_boundaries - 1):
        for batch in (1, 16, 200):
            assert t.memory_estimate(b, batch) == j.memory_estimate(b, batch)
            for train in (False, True):
                assert t.suffix_memory_estimate(b, batch, train) == \
                    j.suffix_memory_estimate(b, batch, train)


def test_profile_layered_quirks_are_kept():
    """BatchNorm's statistics count in bytes and FLOPs; the patch embedding
    counts (768 x 384 + 196 x 384) x 2 x 224 x 224; pools are VALID."""
    _, vit = _profiles("transformer")
    assert vit.cum_flops[1] == (768 * 384 + 196 * 384) * 2 * 224 * 224
    assert vit.total_flops == 45_629_251_584.0
    _, res = _profiles("resnet18")
    assert res.out_bytes[4] == 774_400 == 55 * 55 * 64 * 4
    assert res.prefix_param_bytes[2] - res.prefix_param_bytes[1] == 4 * 64 * 4
    _, alex = _profiles("alexnet")
    assert alex.out_bytes[3] == 27 * 27 * 64 * 4


def test_profile_layered_on_any_device_and_other_heads():
    """The weights' device does not matter (each layer runs on meta copies),
    and the head's width follows ``num_classes``."""
    on_cpu = tprof.profile_layered(tv.resnet18(10, device="cpu"))
    _same_profile(on_cpu, _profiles("resnet18", 10)[0])
    _same_profile(tprof.profile_layered(tv.alexnet(100, device="meta"), headroom=0.2),
                  jprof.profile_layered(jv.alexnet(100), headroom=0.2))


# ---------------------------------------------------------------------------
# Alg. 1 and the cost-optimal split
# ---------------------------------------------------------------------------
# HapiConfig's defaults, a train batch of 1,000: (layers, freeze index,
# parameter bytes, split with an f32 wire, split under compress_transfer).
PAPER_TABLE = {
    "alexnet": (20, 17, 244_403_360, 13, 3),
    "resnet18": (15, 11, 46_801_312, 11, 9),
    "vgg11": (28, 25, 531_453_344, 21, 21),
    "transformer": (14, 11, 88_025_088, 11, 11),
}


@pytest.mark.parametrize("name", MODELS)
def test_the_paper_models_split_as_the_reference(name):
    j, t = _profiles(name)
    layers, freeze, nbytes, split, split_int8 = PAPER_TABLE[name]
    assert (t.n_boundaries - 1, t.freeze_index, t.model_param_bytes) == (layers, freeze, nbytes)
    for compress, want in ((False, split), (True, split_int8)):
        got = tspl.choose_split(t, HapiConfig(compress_transfer=compress), 1000)
        exp = jspl.choose_split(j, JHapi(compress_transfer=compress), 1000)
        assert _fields(got) == _fields(exp)
        assert got.split_index == want
    if name == "transformer":      # no candidate under C: the freeze index
        assert tspl.choose_split(t, HapiConfig(), 1000).reason.startswith("default")


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_choose_split_grid_matches_jax(name, compress):
    j, t = _profiles(name)
    for gbps in (0.05, 0.1, 0.5, 1, 3, 10, 100):
        for batch in (10, 100, 256, 1000, 4000):
            kw = dict(network_bandwidth=gbps * 1e9 / 8, compress_transfer=compress)
            got = tspl.choose_split(t, HapiConfig(**kw), batch)
            exp = jspl.choose_split(j, JHapi(**kw), batch)
            assert _fields(got) == _fields(exp), (gbps, batch)


@pytest.fixture
def same_hbm(monkeypatch):
    """Both packages' cost-optimal splitters at one HBM rate."""
    def use(rate):
        for mod in (jcm, tcm):
            monkeypatch.setattr(mod, "roofline_epoch_time", functools.partial(
                getattr(mod, "roofline_epoch_time"), cos_hbm_bw=rate, client_hbm_bw=rate))
    return use


@pytest.mark.parametrize("hbm", [HW.hbm_bandwidth, TPU_HBM])
@pytest.mark.parametrize("name", MODELS)
def test_choose_split_cost_optimal_matches_jax(name, hbm, same_hbm):
    same_hbm(hbm)
    j, t = _profiles(name)
    for gbps in (0.1, 1, 10):
        for batch in (32, 256, 1000):
            for compress in (False, True):
                for extra in (dict(), dict(n_tenants=4, dataset_size=50_000),
                              dict(measured_bandwidth=3e7, freeze_index=5)):
                    kw = dict(network_bandwidth=gbps * 1e9 / 8, compress_transfer=compress)
                    flops = dict(cos_flops=HW.peak_flops_f32, client_flops=HW.peak_flops_bf16)
                    got = tspl.choose_split_cost_optimal(t, HapiConfig(**kw), batch,
                                                         **flops, **extra)
                    exp = jspl.choose_split_cost_optimal(j, JHapi(**kw), batch,
                                                         **flops, **extra)
                    assert _fields(got) == _fields(exp), (gbps, batch, compress, extra)


def test_cost_model_defaults_to_the_h100():
    sig = inspect.signature(tcm.roofline_epoch_time)
    assert sig.parameters["cos_hbm_bw"].default == 3.35e12
    assert sig.parameters["client_hbm_bw"].default == 3.35e12


# ---------------------------------------------------------------------------
# The cost model (tests/test_cost_model.py's cases, both packages)
# ---------------------------------------------------------------------------
def _tiny(mod, n=8, input_bytes=1e7):
    """tests/test_profiles.py's ``tiny_profile`` in either package."""
    out = [9e6, 8e6, 5e6, 3e6, 2e6, 1e6, 9e5, 5e5][:n]
    return mod.LayerProfile(
        name="tiny", n_boundaries=n + 1, input_bytes=input_bytes,
        out_bytes=[input_bytes] + out,
        cum_flops=[0.0] + [1e9 * (i + 1) for i in range(n)],
        act_peak_bytes=[input_bytes] + [6 * b for b in out],
        prefix_param_bytes=[1e6 * i for i in range(n + 1)],
        model_param_bytes=1e6 * n,
        freeze_index=max(1, n * 3 // 4),
    )


@pytest.mark.parametrize("split", [0, 2, 6])
@pytest.mark.parametrize("tenants", [1, 4])
def test_paper_epoch_time_matches_jax(split, tenants):
    args = (split, 1000, 100, 100, 1e8)
    t = tcm.paper_epoch_time(_tiny(tprof), *args, tcm.PaperConstants(1e-9, 1e-3, 1e-9, 1e-3),
                             n_tenants=tenants)
    j = jcm.paper_epoch_time(_tiny(jprof), *args, jcm.PaperConstants(1e-9, 1e-3, 1e-9, 1e-3),
                             n_tenants=tenants)
    assert _fields(t) == _fields(j) and t.total == j.total
    if split == 0:
        assert t.cos == 0.0


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("split", [0, 2, 6])
def test_roofline_epoch_time_matches_jax(split, overlap):
    for extra in (dict(), dict(measured_bandwidth=5e7), dict(n_tenants=3, compress=0.53)):
        kw = dict(bandwidth=1e8, cos_flops=1e14, client_flops=1e14, overlap=overlap,
                  cos_hbm_bw=2e12, client_hbm_bw=1e12, **extra)
        t = tcm.roofline_epoch_time(_tiny(tprof), split, 1000, 100, **kw)
        j = jcm.roofline_epoch_time(_tiny(jprof), split, 1000, 100, **kw)
        assert _fields(t) == _fields(j) and t.total == j.total
    kw = dict(bandwidth=1e8, cos_flops=1e14, client_flops=1e14)
    base = tcm.roofline_epoch_time(_tiny(tprof), 2, 1000, 100, **kw)
    meas = tcm.roofline_epoch_time(_tiny(tprof), 2, 1000, 100, measured_bandwidth=5e7, **kw)
    assert meas.network == pytest.approx(2 * base.network)
    assert (meas.cos, meas.client) == (base.cos, base.client)
    assert base.total <= tcm.roofline_epoch_time(_tiny(tprof), 2, 1000, 100, overlap=False,
                                                 **kw).total


def test_fit_constants_and_effective_bandwidth_match_jax():
    rng = np.random.default_rng(0)
    meas = []
    for _ in range(20):
        b, by, l = rng.integers(10, 1000), rng.uniform(1e5, 1e7), rng.integers(1, 30)
        meas.append((b, by, l, 2e-9 * b * by + 5e-3 * l))
    assert tcm.fit_constants(meas) == jcm.fit_constants(meas)
    ca, cb = tcm.fit_constants(meas)
    assert abs(ca - 2e-9) / 2e-9 < 1e-6 and abs(cb - 5e-3) / 5e-3 < 1e-6
    for nominal, samples, alpha in ((100.0, (), 0.25), (100.0, [50.0], 0.5),
                                    (125e6, [50e6] * 40, 0.25), (1e9, [3e8, 7e8, 1e8], 0.9)):
        assert tcm.effective_bandwidth(nominal, samples, alpha) == \
            jcm.effective_bandwidth(nominal, samples, alpha)
    assert tcm.effective_bandwidth(100.0, [50.0, 50.0], alpha=0.5) == 62.5
    with pytest.raises(ValueError):
        tcm.effective_bandwidth(1.0, [], alpha=0.0)


@pytest.mark.parametrize("split", [0, 2, 7])
def test_wire_bytes_per_iteration_matches_jax(split):
    for compressed in (False, True):
        assert tcm.wire_bytes_per_iteration(_tiny(tprof), split, 100, compressed=compressed) \
            == jcm.wire_bytes_per_iteration(_tiny(jprof), split, 100, compressed=compressed)
    assert tcm.transferred_per_iteration(_tiny(tprof), split, 100, compress=0.53) == \
        jcm.transferred_per_iteration(_tiny(jprof), split, 100, compress=0.53)


# ---------------------------------------------------------------------------
# Calibration (tests/test_profiler_calibration.py's and test_profiler.py's cases)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.2, 3.0])
@pytest.mark.parametrize("name", ["alexnet", "resnet18"])
def test_calibrate_profile_matches_jax(name, factor):
    j, t = _profiles(name)
    for b, batch in ((5, 128), (t.freeze_index, 16)):
        est = t.memory_estimate(b, batch)
        cal_t = tprof.calibrate_profile(t, b, est * factor, batch)
        cal_j = jprof.calibrate_profile(j, b, est * factor, batch)
        _same_profile(cal_t, cal_j)
        assert cal_t.memory_estimate(b, batch) >= min(est, est * factor) * 0.99
        if factor <= 1.0:
            assert cal_t is t          # already over-estimating: unchanged
        else:
            assert cal_t.memory_estimate(b, batch) >= est * factor * 0.99


@pytest.mark.parametrize("name", ["alexnet", "vgg11", "transformer"])
def test_extrapolation_error_matches_jax(name):
    j, t = _profiles(name)
    b = 5
    truth = t.prefix_param_bytes[b] + 128 * t.act_peak_bytes[b]
    for measured in (truth, truth * 1.1, truth * 0.7, 0.0):
        assert tprof.extrapolation_error(t, b, measured, 128) == \
            jprof.extrapolation_error(j, b, measured, 128)
    assert tprof.extrapolation_error(t, b, truth, 128) < 1.0
    assert tprof.extrapolation_error(t, b, truth * 1.1, 128) < 12.0


def test_memory_estimate_overestimates_and_early_convs_dominate():
    _, res = _profiles("resnet18")
    assert res.memory_estimate(5, 16) > res.prefix_param_bytes[5] + 16 * res.act_peak_bytes[5]
    _, vgg = _profiles("vgg11")
    early = vgg.cum_flops[len(vgg.out_bytes) // 2]
    assert early > vgg.cum_flops[-1] - early           # paper Fig. 3
