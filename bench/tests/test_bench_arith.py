"""The yardstick's arithmetic against numbers worked out by hand: the
rate over a window, model FLOPs and the flash kernels' work from shapes,
and the reduction of a device trace."""
from __future__ import annotations

import pytest

from bench import flops, harness, registry
from bench.devtrace import (WINDOW_RANGE, Event, kernel_class,
                            reduce_events, union_ns)

VIT = registry.config("rapidearth-vit-t")
LM = registry.config("internlm2-1.8b")


def test_vit_t_400_flops_per_image():
    # patch projection 2·(768·192)·625 = 184,320,000; twelve layers of
    # 442,368 product parameters over 626 tokens, 2·442,368·626·12 =
    # 6,646,136,832; attention 4·3·64·626²·12 = 3,611,529,216
    assert flops.vit_flops_per_image(VIT) == 10_441_986_048


def test_internlm2_product_params():
    # a layer: 2048·2048·2 (q, o) + 2048·1024·2 (k, v) + 3·2048·8192 +
    # 2·2048 norms = 62,918,656; 24 of them, the unembedding 2048·92,544
    # and the final norm
    assert flops.lm_product_params(LM) == 24 * 62_918_656 \
        + 2048 * 92_544 + 2048 == 1_699_579_904


@pytest.mark.parametrize("batch,seq,want", [
    # 6·N·16,384 + 3·24·4·4·16·128·(4096·4097/2)
    (4, 4096, 186_871_544_020_992),
    # 6·N·32,768 + 3·24·4·8·16·128·(4096·4097/2): the cell's 8 rows
    (8, 4096, 373_743_088_041_984),
    # 6·N·32,768 + 3·24·4·1·16·128·(32768·32769/2)
    (1, 32768, 650_820_018_241_536)])
def test_internlm2_train_flops(batch, seq, want):
    assert flops.lm_train_flops(LM, batch, seq) == want


def test_flash_forward_work_vit():
    # 4·128·3·64·626² FLOPs; q, k, v, o of 128·626·3·64 float32 each
    f, b = flash = flops.flash_fwd_work(128, 626, 3, 3, 64, False, "float32")
    assert (f, b) == (38_522_978_304, 246_153_216)
    assert flash == (f, b)
    # FLOPs bind at 495e12: 77.8 us
    assert flops.bound_s(f, b, 495e12, 3.35e12) == pytest.approx(
        38_522_978_304 / 495e12)


def test_flash_backward_work_train_4k():
    # four products, 8·4·16·128 a pair over 4096·4097/2 causal pairs;
    # bf16 q, o, dO, dq (4·4096·16·128 each) and k, v, dk, dv
    # (4·4096·8·128 each), float32 lse 4·16·4096
    f, b = flops.flash_bwd_work(4, 4096, 16, 8, 128, True, "bfloat16")
    assert f == 549_890_031_616
    assert b == 2 * (4 * 4 * 4096 * 16 * 128 + 4 * 4 * 4096 * 8 * 128) \
        + 4 * 4 * 16 * 4096 == 403_701_760


def test_peaks_of_the_card():
    pk = flops.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops_per_s"] == 989e12
    assert pk["tf32_flops_per_s"] == 495e12
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert flops.peaks("a card not listed") is None


def test_window_rate_counts_all_units_over_all_the_time(monkeypatch):
    clock = iter([10.0, 10.4, 10.9, 11.3])        # start, three unit ends
    monkeypatch.setattr(harness.time, "perf_counter", lambda: next(clock))
    done = []
    w = harness.window(lambda: done.append(1), seconds=1.2)
    assert (w.units, w.seconds) == (3, pytest.approx(1.3))
    assert len(done) == 3


def test_worst_leaf_gap_against_the_larger_of_leaf_and_median():
    ref = {"a": 1.0, "b": 4.0, "c": 0.001}
    prog = {"a": 1.1, "b": 4.0, "c": 0.101}
    # median 1.0: a reads 0.1/1.0, c reads 0.1/1.0 (not 0.1/0.001)
    assert harness.worst_leaf_gap(prog, ref) == pytest.approx(0.1)
    assert harness.worst_leaf_gap(prog, ref, ["b"]) == 0.0


@pytest.mark.parametrize("name,cls", [
    ("void flash_attention_kernel_f32<64>(...)", "flash_fwd"),
    ("flash_attention_presplit", "flash_fwd"),
    ("flash_bwd_dkdv_bf16", "flash_bwd"),
    ("nvjet_hsh_256x128_64x4_2x1_v_bz_coopA_NTN", "cublas"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32", "cublas"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy_h2d"),
    ("Memcpy DtoH (Device -> Pageable)", "memcpy"),
    ("Memset (Device)", "memset"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other")])
def test_kernel_class(name, cls):
    assert kernel_class(name) == cls


def test_union_of_intervals():
    assert union_ns([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_reduce_events_busy_idle_classes_and_gaps():
    ms = 1_000_000
    host = [Event(WINDOW_RANGE, 0, 100 * ms),
            Event("bench.upload", 0, 30 * ms),
            Event("aten::copy_", 10 * ms, 5 * ms),
            Event("cudaStreamSynchronize", 80 * ms, 20 * ms)]
    device = [Event("Memcpy HtoD (Pageable -> Device)", 10 * ms, 10 * ms),
              Event("flash_attention_kernel_f32", 30 * ms, 20 * ms),
              Event("sm90_xmma_gemm_f32", 40 * ms, 20 * ms),   # overlaps
              Event("elementwise", 95 * ms, 10 * ms)]          # past the end
    r = reduce_events(device, host)
    assert r["window_s"] == pytest.approx(0.1)
    # busy: 10-20, 30-60, 95-100
    assert r["busy_s"] == pytest.approx(0.045)
    by = r["device_s_by_class"]
    assert by["memcpy_h2d"] == pytest.approx(0.010)
    assert by["flash_fwd"] == pytest.approx(0.020)
    assert by["cublas"] == pytest.approx(0.020)
    assert by["other"] == pytest.approx(0.005)
    # gaps: 0-10 and 20-30 begin inside bench.upload, 60-95 where only
    # the window's range covers the host
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps == {"bench.upload": pytest.approx(0.020),
                    WINDOW_RANGE: pytest.approx(0.035)}
    ops = dict(r["breakdown"]["device_ops"])
    assert ops == {"Memcpy HtoD (Pageable -> Device)": pytest.approx(0.010),
                   "flash_attention_kernel_f32": pytest.approx(0.020),
                   "sm90_xmma_gemm_f32": pytest.approx(0.020),
                   "elementwise": pytest.approx(0.005)}


def test_reduce_events_needs_one_window():
    with pytest.raises(ValueError):
        reduce_events([], [])


def test_shares_never_cap():
    """A roofline share is reported as measured: the arithmetic carries
    no min(..., 100)."""
    import inspect
    from bench import devtrace
    assert devtrace.share(3.0, 2.0) == 150.0
    for name in registry.load_benchmark()["per_layer"]:
        src = inspect.getsource(registry.metric_reader(name["name"]))
        assert "min(" not in src


class _Raw:
    """A stand-in for a profiler event, as ``devtrace._annotation``
    reads it."""

    def __init__(self, kind: str, user: bool):
        self._kind, self._user = kind, user

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return self._user


@pytest.mark.parametrize("kind,user,want", [
    ("user_annotation", True, True), ("gpu_user_annotation", False, True),
    ("kernel", False, False), ("gpu_memcpy", False, False)])
def test_ranges_on_the_device_are_not_device_work(kind, user, want):
    from bench.devtrace import _annotation
    assert _annotation(_Raw(kind, user)) is want


def test_nought_gradients_left_out_by_rule():
    from bench.jobs import train
    ref = {"grad_norms": {"a": 1.0, "b": 2.0, "c": 0.0005, "d": 0.5},
           "change_norms": {"a": 1.0, "b": 1.0, "c": 1.0, "d": 1.0},
           "losses": [1.0]}
    prog = dict(ref, change_norms={"a": 1.0, "b": 1.0, "c": 2.0, "d": 1.0})
    # median 0.75: c's gradient is under 0.00075, so its doubled change
    # is not compared
    assert train.gaps(prog, ref)["change_gap"] == 0.0
    assert train.gaps(dict(prog, change_norms=dict(
        prog["change_norms"], d=2.0)), ref)["change_gap"] == 1.0


@pytest.mark.parametrize("seconds,step_s,want", [
    (51.0, 0.86, 60), (51.0, 2.56, 20), (0.0, 1.0, 1), (1.0, 5.0, 1)])
def test_train_window_steps_fill_the_seconds(seconds, step_s, want):
    from bench.jobs import train
    assert train.window_steps(seconds, step_s) == want
