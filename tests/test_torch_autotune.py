"""The port's kernel autotuner (``repro_torch.kernels.autotune``) against
the reference's (``repro.kernels.autotune``, ``tests/test_autotune.py``'s
cases), on the CPU.

Parity runs both packages on the same inputs: numpy draws handed to both,
both tuners built on one explicit DeviceSpec with the same numbers (never
either package's default kind), and the same measured times injected into
both.  The spaces differ by design: the port's variants are the CUDA
kernels' own knobs (K1 query rows per block, K4 chunk, one launch for K2a
and K2b), so parity holds each port variant's output to the reference's at
the same inputs (the reference in interpret mode, the port through its
plain version), and the choice logic to the reference's on K4, whose
chunks are the reference's.  ``test_roofline_uses_device_spec`` is
``tests/test_torch_roofline.py``'s.  The
contention and backlog cases of ``tests/test_autotune.py`` are held by
``tests/test_torch_contention.py``.
"""
import json
import os
import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.autotune.device as RD
import repro.kernels.autotune.table as RT
import repro_torch.kernels.autotune.device as PD
import repro_torch.kernels.autotune.table as T
from repro import obs as robs
from repro.common.config import ChameleonConfig as RChameleonConfig
from repro.common.config import HostMemConfig as RHostMemConfig
from repro.hostmem import HostMemTier as RHostMemTier
from repro.hostmem.bwmodel import BandwidthModel as RBandwidthModel
from repro.kernels.autotune.advisor import \
    CompressionAdvisor as RCompressionAdvisor
from repro.kernels.autotune.cache import AutotuneCache as RAutotuneCache
from repro.kernels.autotune.space import SPACES as RSPACES
from repro.kernels.autotune.tuner import Autotuner as RAutotuner
from repro_torch import obs
from repro_torch.common.config import (AutotuneConfig, ChameleonConfig,
                                       HostMemConfig)
from repro_torch.hostmem import HostMemTier
from repro_torch.hostmem.bwmodel import BandwidthModel
from repro_torch.kernels.autotune import install_cache
from repro_torch.kernels.autotune.advisor import (COMPRESS_INT8, COMPRESS_RAW,
                                                  CompressionAdvisor)
from repro_torch.kernels.autotune.cache import (CACHE_FILENAME,
                                                SCHEMA_VERSION,
                                                AutotuneCache, cache_key)
from repro_torch.kernels.autotune.space import SPACES, torch_dtype
from repro_torch.kernels.autotune.tuner import HOST_LINK_KERNEL, Autotuner

torch.set_num_threads(1)      # tier-1 runs several xdist workers

# one set of peaks for both packages' tuners (the H100's figures)
PEAKS = dict(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
             host_bw=40.2e9)
PSPEC = PD.DeviceSpec("h100_sxm", **PEAKS)
RSPEC = RD.DeviceSpec("h100_sxm", **PEAKS)


@pytest.fixture(autouse=True)
def _clean_tables():
    """Every test starts and ends with both process-wide tables empty."""
    T.clear()
    RT.clear()
    yield
    T.clear()
    RT.clear()


def _port_tuner(measure, cache=None):
    return Autotuner(cache=cache, spec=PSPEC, measure=measure, device="cpu")


def _ref_tuner(measure, cache=None):
    return RAutotuner(cache=cache, spec=RSPEC, measure=measure)


# ---------------------------------------------------------- device spec
def test_device_spec_registry():
    spec = PD.get_device_spec()
    assert spec.kind == PD.DEFAULT_DEVICE_KIND == "h100_sxm"
    assert set(PD.DEVICE_SPECS) == {"h100_sxm", "cpu"}   # no TPU figure
    unknown = PD.get_device_spec("b200")
    assert unknown.kind == "b200"                  # asked-for name kept
    assert unknown.hbm_bw == PD.DEVICE_SPECS["h100_sxm"].hbm_bw
    ref_unknown = RD.get_device_spec("b200")       # the reference's rule
    assert ref_unknown.kind == "b200"
    assert ref_unknown.hbm_bw == RD.DEVICE_SPECS["tpu_v5e"].hbm_bw
    d = spec.to_dict()
    assert d == {"kind": "h100_sxm", **PEAKS}
    assert set(d) == set(RD.get_device_spec().to_dict())


def test_h100_spec_reads_the_config_constants():
    """The spec and ChameleonConfig price with one set of H100 numbers, and
    the spec's host_bw is the Eq-3 constant."""
    c, spec = ChameleonConfig(), PD.DEVICE_SPECS["h100_sxm"]
    assert spec.peak_flops == c.peak_flops
    assert spec.hbm_bw == c.hbm_gbps * 1e9
    assert spec.host_bw == c.host_link_gbps * 1e9
    assert spec.ici_bw == 450e9                    # 900 GB/s both ways
    assert PD.DEVICE_SPECS["cpu"].host_bw == spec.host_bw


@pytest.mark.parametrize("name,kind", [
    ("NVIDIA H100 80GB HBM3", "h100_sxm"),
    ("NVIDIA H100 PCIe", "h100_sxm"),
    ("NVIDIA A100-SXM4-40GB", "nvidia_a100_sxm4_40gb"),
])
def test_device_kind_from_the_card_name(monkeypatch, name, kind):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    assert PD.device_kind(torch.device("cuda", 0)) == kind
    assert PD.device_kind("cpu") == "cpu"
    assert PD.get_device_spec(kind).kind == kind


def test_default_kind_is_the_tiers_device():
    assert AutotuneConfig().device_kind == ""
    tuner = Autotuner(measure=lambda fn: 0.01, device="cpu")
    assert tuner.spec is PD.DEVICE_SPECS["cpu"]
    assert tuner.cache.device_kind == "cpu"


# ------------------------------------------------------- keys / buckets
@pytest.mark.parametrize("shape", [(1000, 900), (1024, 1024), (1025, 1),
                                   (1, 256, 4, 64), (2, 2048, 32, 128),
                                   (3, 7, 33)])
def test_shape_bucket_pow2_rounding(shape):
    assert T.shape_bucket(shape) == RT.shape_bucket(shape)
    assert T.shape_bucket((1000, 900)) == "1024x1024"
    assert T.shape_bucket((1025, 1)) == "2048x1"


def test_dtype_name_normalization():
    for name in ("float32", "bfloat16"):
        tdt = getattr(torch, name)
        assert T.dtype_name(tdt) == name
        assert T.dtype_name(name) == name
        assert T.dtype_name(jnp.zeros((1,), getattr(jnp, name)).dtype) == name
        assert RT.dtype_name(jnp.zeros((1,), getattr(jnp, name)).dtype) == name
        assert torch_dtype(name) is tdt and torch_dtype(tdt) is tdt
    assert T.dtype_name(np.float32) == T.dtype_name(np.dtype(np.float32))
    key = T.table_key("quantize", (1000, 900), torch.float32)
    assert key == T.table_key("quantize", (1024, 1024), np.float32)
    assert key == RT.table_key("quantize", (1000, 900), np.float32)
    assert (T.table_key("ssd_scan", (1, 256, 4, 64), torch.bfloat16)
            == RT.table_key("ssd_scan", (1, 256, 4, 64), jnp.bfloat16))


# ----------------------------------------------------- cache round-trip
def _entry(config=None, bps=1e9):
    return {"config": {"chunk": 64} if config is None else config,
            "achieved_bps": bps, "measured_s": 0.001,
            "bytes_moved": 1 << 20, "efficiency": 0.5,
            "shape": [1024, 1024]}


def test_cache_roundtrip(tmp_path):
    cache = AutotuneCache(str(tmp_path))
    cache.put("quantize", (1024, 1024), torch.float32, _entry({}))
    cache.bwmodel = BandwidthModel(40.2, link_efficiency=0.7).to_dict()
    path = cache.save()
    assert path and os.path.exists(path)
    assert not os.path.exists(path + ".tmp")      # atomic write cleaned up
    loaded = AutotuneCache.load(str(tmp_path))
    assert loaded.entries == cache.entries
    assert loaded.bwmodel["link_efficiency"] == pytest.approx(0.7)
    assert loaded.load_errors == 0
    # bucketed hit/miss, torch and numpy dtypes alike
    assert loaded.get("quantize", (1000, 900), np.float32) is not None
    assert loaded.get("quantize", (2048, 1024), torch.float32) is None
    assert loaded.get("quantize", (1024, 1024), torch.int8) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cache_file_crosses_packages(tmp_path, writer):
    """One schema: either package reads the other's file, entry for entry."""
    make = AutotuneCache if writer == "port" else RAutotuneCache
    read = RAutotuneCache if writer == "port" else AutotuneCache
    cache = make(str(tmp_path), device_kind="h100_sxm")
    cache.put("ssd_scan", (1, 256, 4, 64), np.float32, _entry())
    cache.save()
    loaded = read.load(str(tmp_path), device_kind="h100_sxm")
    assert loaded.entries == cache.entries and loaded.load_errors == 0
    assert loaded.table_entries() == {
        "ssd_scan|1x256x4x64|float32": {"chunk": 64}}


def test_cache_missing_dir_is_empty(tmp_path):
    cache = AutotuneCache.load(str(tmp_path / "nowhere"))
    assert cache.entries == {} and cache.load_errors == 0


@pytest.mark.parametrize("payload", [
    "{garbage",                                    # truncated / not JSON
    json.dumps({"schema_version": 99, "entries": {}}),
    json.dumps({"schema_version": SCHEMA_VERSION, "entries": [1, 2]}),
])
def test_cache_corruption_safe_load(tmp_path, payload):
    (tmp_path / CACHE_FILENAME).write_text(payload)
    cache = AutotuneCache.load(str(tmp_path))
    ref = RAutotuneCache.load(str(tmp_path))
    assert cache.entries == ref.entries == {}
    assert cache.load_errors == ref.load_errors == 1


def test_cache_malformed_entries_skipped_individually(tmp_path):
    good_key = cache_key("quantize", (1024, 1024), torch.float32, "h100_sxm")
    payload = {"schema_version": SCHEMA_VERSION,
               "entries": {good_key: _entry({}),
                           "bad-key": _entry(),
                           "a|b|c|d": "not-a-dict",
                           "e|f|g|h": {"no_config": True}}}
    (tmp_path / CACHE_FILENAME).write_text(json.dumps(payload))
    cache = AutotuneCache.load(str(tmp_path))
    ref = RAutotuneCache.load(str(tmp_path))
    assert list(cache.entries) == list(ref.entries) == [good_key]
    assert cache.load_errors == ref.load_errors == 3


def test_table_entries_drop_other_devices():
    cache = AutotuneCache(device_kind="h100_sxm")
    cache.put("ssd_scan", (1, 256, 4, 64), torch.float32, _entry())
    cache.entries[cache_key("ssd_scan", (1, 256, 4, 64), torch.float32,
                            "cpu")] = _entry({"chunk": 128})
    assert list(cache.table_entries().values()) == [{"chunk": 64}]


# ----------------------------------------------- tuner counters / cache
@pytest.mark.parametrize("kernel", sorted(SPACES))
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_tuner_measures_all_variants_once(kernel, dname):
    tuner = _port_tuner(lambda fn: 0.01)
    variants = SPACES[kernel].variants_for(dname)
    cfg = tuner.tune(kernel, dtype=getattr(torch, dname))
    assert cfg in list(variants)
    assert tuner.n_measured == len(variants) and tuner.n_cache_hits == 0
    # same bucket: answered from cache, zero new measurements
    shape = [max(d - 1, 1) for d in SPACES[kernel].default_shape]
    assert tuner.tune(kernel, shape=shape, dtype=dname) == cfg
    assert tuner.n_measured == len(variants) and tuner.n_cache_hits == 1
    # as the reference's tuner counts on its own space
    ref = _ref_tuner(lambda fn: 0.01)
    ref.tune(kernel)
    assert ref.n_measured == len(RSPACES[kernel].variants)


def test_k1_variants_are_the_kernels_rows_per_block():
    sp = SPACES["flash_attention"]
    assert sp.variants_for(torch.bfloat16) == ({"block_q": 128},
                                               {"block_q": 64})
    assert sp.variants_for(torch.float32) == ({"block_q": 64},)
    assert SPACES["ssd_scan"].variants == RSPACES["ssd_scan"].variants
    assert SPACES["quantize"].variants == SPACES["dequantize"].variants == ({},)


def test_warm_restart_zero_remeasurement(tmp_path):
    t1 = _port_tuner(lambda fn: 0.01, AutotuneCache(str(tmp_path)))
    t1.tune_all(("quantize", "dequantize", "ssd_scan"))
    assert t1.n_measured == 5
    t1.cache.save()
    # cold process, warm directory
    t2 = _port_tuner(lambda fn: pytest.fail("re-measured!"),
                     AutotuneCache.load(str(tmp_path)))
    t2.tune_all(("quantize", "dequantize", "ssd_scan"))
    assert t2.n_measured == 0 and t2.n_cache_hits == 3


def _timed(variants, fast):
    """A measure that gives ``fast`` 1 ms and every other variant 10 ms,
    in the order the tuner measures them."""
    it = iter([0.001 if dict(v) == fast else 0.01 for v in variants])
    return lambda fn: next(it)


def test_tuner_picks_fastest_variant():
    """K4's chunks are the reference's: the same injected times make both
    tuners keep chunk 64, with the same efficiency rule."""
    fast = {"chunk": 64}                           # not the default
    port = _port_tuner(_timed(SPACES["ssd_scan"].variants, fast))
    ref = _ref_tuner(_timed(RSPACES["ssd_scan"].variants, fast))
    assert port.tune("ssd_scan") == ref.tune("ssd_scan") == fast
    shape = SPACES["ssd_scan"].default_shape
    entry = port.cache.get("ssd_scan", shape, torch.float32)
    nbytes = SPACES["ssd_scan"].bytes_moved(shape, torch.float32)
    assert entry["achieved_bps"] == pytest.approx(nbytes / 0.001)
    assert entry["efficiency"] == pytest.approx(nbytes / 0.001 / PSPEC.hbm_bw)
    rentry = ref.cache.get("ssd_scan", shape, np.float32)
    assert entry["measured_s"] == rentry["measured_s"] == 0.001
    # K1's rows per block, as the kernel would rank them
    k1 = _port_tuner(_timed(SPACES["flash_attention"].variants,
                            {"block_q": 64}))
    assert k1.tune("flash_attention", dtype=torch.bfloat16) == {"block_q": 64}


@pytest.mark.parametrize("kernel", ["quantize", "dequantize",
                                    "flash_attention"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bytes_moved_matches_reference(kernel, dname):
    shape = SPACES[kernel].default_shape
    assert shape == RSPACES[kernel].default_shape
    assert (SPACES[kernel].bytes_moved(shape, getattr(torch, dname))
            == RSPACES[kernel].bytes_moved(shape, getattr(jnp, dname)))


def test_ssd_bytes_count_dt_in_f32():
    """The port's K4 reads dt in f32 whatever x's dtype; the reference
    counts dt in x's dtype.  Everything else is the same."""
    shape = SPACES["ssd_scan"].default_shape
    B, S, H, _ = shape
    assert (SPACES["ssd_scan"].bytes_moved(shape, torch.float32)
            == RSPACES["ssd_scan"].bytes_moved(shape, np.float32))
    assert (SPACES["ssd_scan"].bytes_moved(shape, torch.bfloat16)
            == RSPACES["ssd_scan"].bytes_moved(shape, jnp.bfloat16)
            + B * S * H * 2)


@pytest.mark.parametrize("kernel", sorted(SPACES))
def test_make_args_from_a_seed_on_the_device(kernel):
    sp = SPACES[kernel]
    shape = (64, 32) if kernel.endswith("quantize") else (1, 64, 2, 16)
    a, b = (sp.make_args(shape, torch.bfloat16, torch.device("cpu"))
            for _ in range(2))
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.device.type == "cpu" and torch.equal(x, y)
    assert a[0].shape == shape
    assert a[0].dtype == (torch.int8 if kernel == "dequantize"
                          else torch.bfloat16)


# ------------------------------------------------------ variant parity
def _to_torch(a, dname=None):
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)
                                  if a.dtype == jnp.bfloat16 else a))
    return t.to(getattr(torch, dname)) if dname else t


@pytest.mark.parametrize("kernel,shape,dname", [
    ("quantize", (256, 64), "float32"),
    ("quantize", (256, 64), "bfloat16"),
    ("dequantize", (256, 64), "float32"),
    ("dequantize", (256, 64), "bfloat16"),
    ("flash_attention", (1, 256, 2, 32), "float32"),
    ("flash_attention", (1, 256, 2, 32), "bfloat16"),
    ("ssd_scan", (1, 256, 2, 32), "float32"),
])
def test_every_variant_matches_reference(kernel, shape, dname):
    """Tuning never trades numerics for speed: every config of the port's
    space reproduces the reference kernel (interpret mode) on the same
    inputs.  Limits: K2a one quantum on < 1% of entries (XLA may fuse x/s
    into x*(1/s)) and scales to 1e-6; K2b to 1e-6 (f32) or one bf16 ulp;
    K1 and K4 the reference test's 2e-3 (bf16: 2e-2, bf16 inputs and
    output)."""
    rsp, sp = RSPACES[kernel], SPACES[kernel]
    jdt = getattr(jnp, dname)
    rargs = rsp.make_args(shape, jdt)
    if kernel == "dequantize":
        q, s, _ = rargs
        args = (_to_torch(q), _to_torch(s), getattr(torch, dname))
    else:
        args = tuple(_to_torch(a, dname if i in (0, 3, 4) or
                               kernel == "flash_attention" else "float32")
                     for i, a in enumerate(rargs))
    for config in sp.variants_for(dname):
        rconfig = config if kernel == "ssd_scan" else rsp.default
        ref = rsp.run(rargs, rconfig)
        out = sp.run(args, config)
        if kernel == "quantize":
            (q, s), (qr, sr) = out, ref
            diff = np.abs(q.numpy().astype(np.int32)
                          - np.asarray(qr, np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-6)
            continue
        if kernel == "ssd_scan":
            out = out[0]                           # y; the reference's run
        tol = {"dequantize": (1e-6 if dname == "float32" else 2.0 ** -7, 0)
               }.get(kernel, (2e-3, 2e-3) if dname == "float32"
                     else (2e-2, 2e-2))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=tol[0], atol=tol[1])


# ------------------------------------------- table -> ops wrapper wiring
def _ssd_inputs(shape=(1, 200, 2, 16), N=16, seed=0):
    rng = np.random.RandomState(seed)
    B, S, H, P = shape
    return (rng.randn(B, S, H, P).astype(np.float32) * 0.5,
            np.abs(rng.randn(B, S, H)).astype(np.float32) * 0.1,
            -(np.abs(rng.randn(H)).astype(np.float32) + 0.5),
            rng.randn(B, S, N).astype(np.float32) * 0.3,
            rng.randn(B, S, N).astype(np.float32) * 0.3)


def test_ssd_scan_reads_installed_chunk():
    """``ssd_scan(chunk=None)`` takes the table's chunk, else 256, in both
    packages; the port's plain version at that chunk is what runs here."""
    from repro.kernels.ssd_scan import ops as RS
    from repro_torch.kernels.ssd_scan import ops as S
    ins = _ssd_inputs()
    tins = [torch.from_numpy(a) for a in ins]
    y256, _ = S.ssd_scan_plain(*tins, chunk=256)
    y, _ = S.ssd_scan(*tins)
    assert torch.equal(y, y256)
    shape = tins[0].shape
    T.install({T.table_key("ssd_scan", shape, torch.float32): {"chunk": 64}})
    RT.install({RT.table_key("ssd_scan", shape, np.float32): {"chunk": 64}})
    y64, _ = S.ssd_scan_plain(*tins, chunk=64)
    y, _ = S.ssd_scan(*tins)
    assert torch.equal(y, y64)
    assert S.ssd_scan.tuned_launches == 0         # the CPU launches nothing
    ry = RS.ssd_scan(*(jnp.asarray(a) for a in ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=2e-3,
                               atol=2e-3)


def test_flash_attention_reads_installed_rows():
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops as F
    q = torch.zeros(2, 2048, 32, 128, dtype=torch.bfloat16)
    assert F.tuned_block_q(q) is None             # no table: kernel's rule
    T.install({T.table_key("flash_attention", (2, 2000, 32, 128),
                           torch.bfloat16): {"block_q": 64}})
    assert F.tuned_block_q(q) == 64
    assert F.tuned_block_q(q.float()) is None     # another dtype's bucket
    assert [K.warpgroups(torch.bfloat16, r) for r in (None, 64, 128)] == [
        0, 1, 2]
    assert K.warpgroups(torch.float32, 64) == 0
    for dt, rows in ((torch.bfloat16, 96), (torch.float32, 128)):
        with pytest.raises(ValueError, match="query rows"):
            K.warpgroups(dt, rows)


def test_install_cache_roundtrip():
    cache = AutotuneCache()
    cache.put("ssd_scan", (1, 256, 4, 64), torch.float32,
              {"config": {"chunk": 64}, "achieved_bps": 1e9})
    cache.put("quantize", (1024, 1024), torch.bfloat16,
              {"config": {}, "achieved_bps": 1e9})
    assert install_cache(cache) == 2 == T.installed_count()
    assert T.tuned_config("ssd_scan", (1, 256, 4, 64),
                          np.float32) == {"chunk": 64}
    assert T.tuned_config("quantize", (1000, 1000), torch.bfloat16) == {}


# --------------------------------------------------- link efficiency
CURVE_GBPS = 16.0


def _calibrated(make, gbps=CURVE_GBPS, constant=40.2):
    bw = make(constant)
    for size in (1 << 16, 1 << 20, 1 << 24):
        bw.observe(size, size / (gbps * 1e9))
    return bw


def test_link_efficiency_from_calibrated_model():
    tuner = _port_tuner(lambda fn: 0.01)
    eff = tuner.link_efficiency(_calibrated(BandwidthModel))
    ref = _ref_tuner(lambda fn: 0.01).link_efficiency(
        _calibrated(RBandwidthModel))
    assert eff == pytest.approx(ref, rel=1e-12)
    assert eff == pytest.approx(CURVE_GBPS * 1e9 / PSPEC.host_bw, rel=0.05)
    stored = tuner.cache.entries[
        f"{HOST_LINK_KERNEL}|-|-|{tuner.cache.device_kind}"]
    assert stored["config"]["efficiency"] == pytest.approx(eff)
    # uncalibrated model + warm cache: reuse the stored value
    t2 = _port_tuner(lambda fn: 0.01, tuner.cache)
    assert t2.link_efficiency(BandwidthModel(40.2)) == pytest.approx(eff)
    assert t2.n_cache_hits == 1
    # nothing stored and nothing calibrated: the Eq-3 constant
    assert _port_tuner(lambda fn: 0.01).link_efficiency(None) == 1.0


def _toy_profile(mod, n_ops=100):
    tensors = [mod.TensorInstance(i, 1 << 20, i, n_ops - i, site="ffn_pre",
                                  layer=i) for i in range(10)]
    return mod.ProfileData(np.zeros(n_ops, np.int32), tensors, 1.0, 0)


def test_t_swap_derated_by_link_efficiency():
    import repro.core.profiler as RP
    import repro_torch.core.profiler as PP
    from repro.core.simulator import Simulator as RSimulator
    from repro_torch.core.simulator import Simulator
    nbytes = 1 << 20
    out = {}
    for name, sim, prof, cfg, bw in (
            ("port", Simulator, _toy_profile(PP),
             ChameleonConfig(groups_per_phase=8, host_link_gbps=32.0),
             BandwidthModel),
            ("ref", RSimulator, _toy_profile(RP),
             RChameleonConfig(groups_per_phase=8, host_link_gbps=32.0),
             RBandwidthModel)):
        full = sim(prof, 50, cfg, bwmodel=bw(32.0, link_efficiency=1.0))
        half = sim(prof, 50, cfg, bwmodel=bw(32.0, link_efficiency=0.5))
        assert half.t_swap(nbytes) == pytest.approx(2 * full.t_swap(nbytes))
        # a *calibrated* curve is already a measurement — never derated
        cal_bw = _calibrated(bw, constant=32.0)
        cal_bw.set_link_efficiency(0.5)
        cal = sim(prof, 50, cfg, bwmodel=cal_bw)
        assert cal.t_swap(nbytes) == pytest.approx(
            cal_bw.transfer_time(nbytes))
        out[name] = (full.t_swap(nbytes), half.t_swap(nbytes),
                     cal.t_swap(nbytes))
    assert out["port"] == pytest.approx(out["ref"], rel=1e-12)


def test_no_double_derating_of_the_measured_link():
    """``host_bw`` is the Eq-3 constant, itself measured on the card: a
    link calibrated at that rate gives an efficiency of 1, and the Eq-3
    bandwidth a restart prices with (uncalibrated model, the stored
    efficiency) stays the constant.  A nominal 64 GB/s PCIe peak in its
    place would derate the measured 40.2 GB/s to ~25."""
    from repro_torch.core.simulator import Simulator
    import repro_torch.core.profiler as PP
    cfg = ChameleonConfig(groups_per_phase=8)
    spec = PD.DEVICE_SPECS["h100_sxm"]
    assert spec.host_bw == cfg.host_link_gbps * 1e9
    link = _calibrated(BandwidthModel, gbps=cfg.host_link_gbps)
    tuner = Autotuner(spec=spec, measure=lambda fn: 0.01, device="cpu")
    eff = tuner.link_efficiency(link)
    assert eff == pytest.approx(1.0, rel=1e-9)
    restart = BandwidthModel(cfg.host_link_gbps, link_efficiency=eff)
    sim = Simulator(_toy_profile(PP), 50, cfg, bwmodel=restart)
    nbytes = 1 << 26
    assert sim.t_swap(nbytes) == pytest.approx(
        nbytes / (cfg.host_link_gbps * 1e9), rel=1e-9)
    nominal = PD.DeviceSpec("h100_pcie_nominal", spec.peak_flops,
                            spec.hbm_bw, spec.ici_bw, 64e9)
    twice = Autotuner(spec=nominal, measure=lambda fn: 0.01,
                      device="cpu").link_efficiency(link)
    assert cfg.host_link_gbps * twice == pytest.approx(
        cfg.host_link_gbps ** 2 / 64, rel=1e-9)


def test_link_efficiency_survives_snapshot_roundtrip():
    bw = BandwidthModel(40.2, link_efficiency=0.4)
    assert BandwidthModel.from_dict(bw.to_dict()).link_efficiency == \
        pytest.approx(0.4)
    assert BandwidthModel.from_dict(
        BandwidthModel(40.2).to_dict()).link_efficiency == 1.0


# ------------------------------------------------ compression advisor
def _skewed_cache(make, bps):
    cache = make()
    for k in ("quantize", "dequantize"):
        cache.put(k, (1024, 1024), np.float32,
                  {"config": {}, "achieved_bps": bps})
    return cache


@pytest.mark.parametrize("gbps,bps,want", [
    (1.0, 1e15, COMPRESS_INT8),                   # slow link, free kernels
    (1000.0, 1e3, COMPRESS_RAW),                  # fast link, slow kernels
    (40.2, 2.6e12, COMPRESS_INT8),                # the card's own numbers
])
def test_advisor_prices_like_the_reference(gbps, bps, want):
    adv = CompressionAdvisor(bwmodel=BandwidthModel(gbps),
                             cache=_skewed_cache(AutotuneCache, bps))
    ref = RCompressionAdvisor(bwmodel=RBandwidthModel(gbps),
                              cache=_skewed_cache(RAutotuneCache, bps))
    choice, detail = adv.decide(1 << 20, 4, rows=256)
    rchoice, rdetail = ref.decide(1 << 20, 4, rows=256)
    assert choice == rchoice == want
    assert detail == pytest.approx(rdetail, rel=1e-12)
    assert adv.stats() == {"n_int8": int(want == COMPRESS_INT8),
                           "n_raw": int(want == COMPRESS_RAW)}


def test_advisor_decision_is_audited():
    adv = CompressionAdvisor(bwmodel=BandwidthModel(1.0),
                             cache=_skewed_cache(AutotuneCache, 1e15))
    adv.decide(1 << 20, 4, rows=256, tag="probe-row")
    ev = [e for e in obs.audit().tail(20, "kvspill.compression_choice")
          if e.get("tag") == "probe-row"]
    assert ev and ev[-1]["choice"] == COMPRESS_INT8
    assert ev[-1]["raw_us"] > 0


def test_advisor_untuned_reduces_to_static_int8_rule():
    adv = CompressionAdvisor(bwmodel=BandwidthModel(40.2), cache=None)
    assert adv.decide(1 << 20, 4, rows=256)[0] == COMPRESS_INT8
    ref = RCompressionAdvisor(bwmodel=RBandwidthModel(40.2), cache=None)
    assert ref.decide(1 << 20, 4, rows=256)[0] == COMPRESS_INT8


# -------------------------------------------- auto spill compression
class _State(typing.NamedTuple):
    attn_k: object
    pos: object


def _toy_np(rows=64, cols=512):
    rng = np.random.RandomState(0)
    return rng.randn(2, 2, rows, cols).astype(np.float32)


def _auto_tier(advisor):
    tier = HostMemTier(HostMemConfig(spill_compression="auto",
                                     spill_compress_min_bytes=1),
                       device="cpu")
    tier.kvspill.advisor = advisor
    return tier


def _ref_auto_kinds(advisor):
    tier = RHostMemTier(RHostMemConfig(spill_compression="auto",
                                       spill_compress_min_bytes=1))
    tier.kvspill.advisor = advisor
    state = _State(jnp.asarray(_toy_np()), jnp.asarray([5, 7], jnp.int32))
    sp = tier.kvspill.spill(state, 0, tag="ref")
    kinds = [(fs.kind, fs.nbytes) for fs in sp.layout]
    tier.kvspill.discard(sp)
    return kinds


@pytest.mark.parametrize("gbps,bps,kind", [(1.0, 1e15, "int8"),
                                           (1000.0, 1e3, "raw")])
def test_auto_compression_follows_the_price(gbps, bps, kind):
    """Cheap kernels over a slow link: every field int8; dear kernels over
    a fast link: every field raw — the reference's layout either way."""
    tier = _auto_tier(CompressionAdvisor(
        bwmodel=BandwidthModel(gbps), cache=_skewed_cache(AutotuneCache, bps)))
    state = _State(torch.from_numpy(_toy_np()), torch.tensor([5, 7]))
    sp = tier.kvspill.spill(state, 0, tag=f"auto-{kind}")
    assert all(fs.kind == kind for fs in sp.layout)
    assert tier.kvspill.stats()["advisor"][f"n_{kind}"] >= 1
    assert [(fs.kind, fs.nbytes) for fs in sp.layout] == _ref_auto_kinds(
        RCompressionAdvisor(bwmodel=RBandwidthModel(gbps),
                            cache=_skewed_cache(RAutotuneCache, bps)))
    tier.kvspill.discard(sp)
    assert tier.pool.bytes_in_use == 0


def test_auto_roundtrip_restores_state():
    before = torch.from_numpy(_toy_np())
    state = _State(before.clone(), torch.tensor([5, 7]))
    tier = _auto_tier(CompressionAdvisor(
        bwmodel=BandwidthModel(1.0), cache=_skewed_cache(AutotuneCache, 1e15)))
    sp = tier.kvspill.spill(state, 0, tag="rt")
    state.attn_k[:, 0] = 0                        # a new tenant's writes
    state.pos[0] = 0
    back = tier.kvspill.restore(state, sp, 0)
    # half a quantization step per element: absmax / 127 / 2 of each row
    half_step = before[:, 0].abs().amax(-1, keepdim=True) / 254
    assert ((back.attn_k[:, 0] - before[:, 0]).abs()
            <= half_step * (1 + 1e-6)).all()
    assert torch.equal(back.attn_k[:, 1], before[:, 1])
    assert int(back.pos[0]) == 5
    assert tier.pool.bytes_in_use == 0


def test_auto_without_advisor_behaves_like_int8():
    tier = _auto_tier(None)
    state = _State(torch.from_numpy(_toy_np()), torch.tensor([5, 7]))
    sp = tier.kvspill.spill(state, 0, tag="fallback")
    assert all(fs.kind == "int8" for fs in sp.layout)
    assert tier.kvspill.stats()["advisor"] is None
    tier.kvspill.discard(sp)


def test_auto_tier_builds_its_advisor_on_the_tiers_link():
    tier = HostMemTier(HostMemConfig(spill_compression="auto"), device="cpu")
    assert tier.kvspill.advisor.bwmodel is tier.bwmodel
    assert tier.kvspill.advisor.cache is None     # untuned: the int8 rule


# ------------------------------------------------- tier-level wiring
@pytest.fixture
def fixed_measure(monkeypatch):
    import repro_torch.kernels.autotune.tuner as tuner_mod
    monkeypatch.setattr(tuner_mod, "default_measure",
                        lambda fn, iters=3, device=None: 0.01)


def test_tier_autotune_warm_restart(tmp_path, fixed_measure):
    atcfg = AutotuneConfig(enabled=True, cache_dir=str(tmp_path), iters=1)
    tier = HostMemTier(HostMemConfig(spill_compression="auto"), device="cpu")
    t1 = tier.autotune(atcfg)
    assert t1.n_measured == 2 and t1.spec.kind == "cpu"
    assert os.path.exists(os.path.join(str(tmp_path), CACHE_FILENAME))
    assert T.installed_count() >= 2
    assert tier.kvspill.advisor.cache is t1.cache  # advisor reads the rates
    t2 = HostMemTier(device="cpu").autotune(atcfg)  # cold process, warm dir
    assert t2.n_measured == 0 and t2.n_cache_hits >= 2
    # an explicit kind wins over the tier's device
    t3 = HostMemTier(device="cpu").autotune(atcfg, device_kind="h100_sxm")
    assert t3.spec is PD.DEVICE_SPECS["h100_sxm"] and t3.n_measured == 2


def test_from_chameleon_triggers_autotune(tmp_path, fixed_measure):
    ccfg = ChameleonConfig(
        autotune=AutotuneConfig(enabled=True, cache_dir=str(tmp_path)))
    tier = HostMemTier.from_chameleon(ccfg, device="cpu")
    assert tier.autotuner is not None
    assert tier.autotuner.stats()["cache"]["entries"] >= 2
    assert tier.bwmodel.link_efficiency == 1.0     # uncalibrated, nothing stored


# ------------------------------------------------------------- the CLIs
def test_serve_cli_autotune_auto_spill(tmp_path, capsys):
    from repro_torch.launch import serve
    argv = ["--arch", "llama2-paper", "--reduced", "--device", "cpu",
            "--requests", "6", "--max-batch", "2", "--max-active", "4",
            "--autotune", "--spill-compression", "auto",
            "--autotune-cache-dir", str(tmp_path)]
    stats = serve.main(argv)
    kv, adv = stats["kvspill"], stats["kvspill"]["advisor"]
    assert stats["preemptions"] > 0 and stats["completed"] == 6
    assert kv["n_spills"] == kv["n_restores"] > 0
    assert stats["hostmem"]["pool"]["bytes_in_use"] == 0
    assert adv["n_int8"] + adv["n_raw"] == 2 * kv["n_spills"]   # k and v rows
    assert stats["autotune"]["n_measured"] == 2
    out = capsys.readouterr().out
    assert f"spill advisor: {adv['n_int8']} rows int8, {adv['n_raw']} raw" \
        in out
    # every row priced one way: the tokens of that static mode's run
    if adv["n_int8"] == 0 or adv["n_raw"] == 0:
        mode = "none" if adv["n_int8"] == 0 else "int8"
        static = serve.main(argv[:-5] + ["--spill-compression", mode])
        assert stats["results"] == static["results"]
    again = serve.main(argv)                      # warm cache dir
    assert again["autotune"]["n_measured"] == 0
    assert again["autotune"]["n_cache_hits"] == 2


def test_train_cli_autotune_runs(tmp_path, fixed_measure):
    from repro_torch.launch import train
    store = str(tmp_path / "store")
    stats = train.main(["--reduced", "--device", "cpu", "--steps", "1",
                        "--seq", "32", "--global-batch", "2", "--autotune",
                        "--policy-store-dir", store,
                        "--ckpt-dir", str(tmp_path)])
    assert stats["autotune"]["n_measured"] == 2
    assert stats["autotune"]["cache"]["dir"] == os.path.join(store,
                                                              "autotune")
    assert os.path.exists(os.path.join(store, "autotune", CACHE_FILENAME))
