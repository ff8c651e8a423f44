"""The port's roofline extraction (``repro_torch.launch.roofline``), on the
CPU: the cases of ``tests/test_roofline_extraction.py`` and
``tests/test_autotune.py::test_roofline_uses_device_spec``.

The reference walks a jaxpr (scan multiplicity) and parses HLO text (while
trip counts); the port counts an eager step as it runs (``step_cost``), so
a loop of 10 runs 10 times and recompute under ``torch.utils.checkpoint``
runs again in the backward.  Collective bytes come from the c10d ops a
fake process group records (one process, no wire).  Every count here is
exact.
"""
import pytest
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro.kernels.autotune.device import get_device_spec as ref_spec
from repro.launch import roofline as RR
from repro_torch.kernels.autotune.device import DeviceSpec, get_device_spec
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import roofline as R


def test_matmul_flops_and_bytes():
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    cost, out = R.step_cost(lambda: a @ b)
    assert out.shape == (64, 32)
    assert cost.flops == pytest.approx(2 * 64 * 128 * 32)
    assert cost.hbm_bytes == pytest.approx((64 * 128 + 128 * 32 + 64 * 32)
                                           * 4)
    assert cost.collectives == {} and cost.wire_bytes == 0


def test_loop_iterations_multiply():
    x, ws = torch.ones(16, 64), torch.ones(10, 64, 64)

    def f():
        h = x
        for i in range(10):
            h = torch.tanh(h @ ws[i])
        return h

    cost, _ = R.step_cost(f)
    assert cost.flops == pytest.approx(10 * 2 * 16 * 64 * 64)


def test_checkpoint_recompute_is_visible():
    x = torch.ones(32, 32, requires_grad=True)
    w = torch.ones(32, 32)

    def g(x):
        return torch.sum(torch.tanh(x @ w) ** 2)

    remat, _ = R.step_cost(lambda: torch.autograd.grad(
        torch.utils.checkpoint.checkpoint(g, x, use_reentrant=False), x))
    plain, _ = R.step_cost(lambda: torch.autograd.grad(g(x), x))
    assert remat.flops > plain.flops
    assert remat.flops - plain.flops == pytest.approx(2 * 32 * 32 * 32)


def test_roofline_terms_bottleneck():
    """The reference's numbers on a spec with the reference's default
    rates (1 s compute, 0.5 s memory, 2 s collective)."""
    spec = DeviceSpec("ref_rates", 197e12, 819e9, 50e9, 32e9)
    t = R.RooflineTerms(
        flops_per_chip=197e12,
        bytes_per_chip=819e9 / 2,
        wire_bytes_per_chip=50e9 * 2,
        collectives={}, chips=256,
        model_flops=0.8 * 197e12 * 256).finalize(spec)
    assert t.bottleneck == "collective"
    assert t.step_time_bound_s == pytest.approx(2.0)
    assert t.mfu_bound == pytest.approx(0.4)
    assert t.useful_flops_ratio == pytest.approx(0.8)
    r = RR.RooflineTerms(flops_per_chip=197e12, bytes_per_chip=819e9 / 2,
                         wire_bytes_per_chip=50e9 * 2, collectives={},
                         chips=256, model_flops=0.8 * 197e12 * 256)
    if ref_spec().peak_flops == spec.peak_flops:
        r.finalize()
        assert (r.bottleneck, r.step_time_bound_s, r.mfu_bound) == (
            t.bottleneck, pytest.approx(t.step_time_bound_s),
            pytest.approx(t.mfu_bound))


def test_model_flops():
    assert R.model_flops_train(10 ** 9, 10 ** 6) == 6e15
    assert R.model_flops_decode(10 ** 9, 8) == RR.model_flops_decode(
        10 ** 9, 8)
    assert R.mfu(989e12 * 0.25, 1, 1.0) == pytest.approx(0.25)


def test_roofline_uses_device_spec():
    spec = get_device_spec()
    assert R.PEAK_FLOPS == spec.peak_flops
    assert R.HBM_BW == spec.hbm_bw
    assert R.ICI_BW == spec.ici_bw and R.HOST_BW == spec.host_bw
    assert spec.kind == "h100_sxm"
    t = R.analyze(R.StepCost(989e12, 0.0), chips=1, model_flops=989e12,
                  device_kind="h100_sxm")
    assert t.compute_s == pytest.approx(1.0) and t.mfu_bound == 1.0


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_bytes_per_kind(fake_group):
    """An f32[128, 256] all-reduce run 24 times moves 128·256·4·2·24 bytes
    (ring: twice its bytes); an all-gather into f32[512, 256] its result's
    bytes; a reduce-scatter its result's."""
    x = torch.ones(128, 256)
    out = torch.empty(512, 256)

    def step():
        for _ in range(24):
            dist.all_reduce(x)
        dist.all_gather_into_tensor(out, x)
        dist.reduce_scatter_tensor(torch.empty(32, 256), x)

    cost, _ = R.step_cost(step)
    assert cost.collectives["all-reduce"] == pytest.approx(
        128 * 256 * 4 * 2 * 24)
    assert cost.collectives["all-gather"] == pytest.approx(512 * 256 * 4)
    assert cost.collectives["reduce-scatter"] == pytest.approx(32 * 256 * 4)
    assert cost.wire_bytes == pytest.approx(sum(cost.collectives.values()))


def _pairs(B, Sq, Sk, causal, lens=None):
    """(query, key) pairs ``chip_smoke.attention_bound`` counts."""
    lens = lens or [Sk] * B
    total = 0
    for n in lens:
        n = min(max(n, 0), Sk)
        total += (sum(min(q + 1, n) for q in range(Sq)) if causal
                  else Sq * n)
    return total


@pytest.mark.parametrize("causal,Sq,Sk,lens", [
    (True, 48, 48, None), (True, 40, 56, None), (False, 24, 40, [40, 17])])
def test_k1_flops_match_attention_bound(causal, Sq, Sk, lens):
    """K1's forward counts 4·D and its backward 10·D flops per unmasked
    (query, key) pair and head, whatever runs below the custom op (here
    the plain version)."""
    B, H, Kh, D = 2, 4, 2, 32
    q = torch.randn(B, Sq, H, D, requires_grad=True)
    k = torch.randn(B, Sk, Kh, D, requires_grad=True)
    v = torch.randn(B, Sk, Kh, D, requires_grad=True)
    kv = None if lens is None else torch.tensor(lens)
    fwd, out = R.step_cost(lambda: ops.flash_attention(
        q, k, v, causal=causal, kv_lens=kv))
    pairs = _pairs(B, Sq, Sk, causal, lens)
    assert fwd.flops == 4 * H * D * pairs
    both, _ = R.step_cost(lambda: ops.flash_attention(
        q, k, v, causal=causal, kv_lens=kv).sum().backward())
    assert both.flops == 14 * H * D * pairs


def test_tagged_residuals_count_twice():
    from repro_torch.core.sites import tag
    x = torch.ones(16, 16)
    cost, _ = R.step_cost(lambda: tag(x * 2, "ffn_act"))
    assert cost.hbm_bytes == 2 * 16 * 16 * 4
