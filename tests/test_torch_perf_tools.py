"""The port's speed instruments (tinyfaces_tpu_torch/tools/) on the CPU at a
tiny size, against the JAX package's tools where they compute the same
thing.

* wire_stats: `content_images` bit-equal to tools/wire_stats.py's, and
  `measure`'s jpeg_Bpx, nonzero_ac, v3_Bpx and v3_drop_pct equal to the
  JAX `measure`'s on the same images (exact: the same JPEG bytes, the
  same coefficients, the same wire);
* serving_bench: `run_level`'s arrival schedule (how many requests, in
  which order of inputs) equals the JAX `run_level`'s for the same seed
  and duration, against a stub service that answers at once;
* profile_model: the count at the 768x1024 level within 1% of the sum of
  2 x multiply-adds over the convolutions' shapes, reckoned here;
* device_profile: the analysis of a synthetic trace (exact busy and idle
  shares, ranking, classes), and a trace with no CUDA event fails;
* every tool's function runs on device="cpu" at stage_sizes=(1, 1, 1)
  and returns its keys.
"""

import json
import time

import numpy as np
import pytest
import torch

import tools.serving_bench as jax_serving_bench
import tools.wire_stats as jax_wire_stats
from tests.test_torch_native import jax_native_library  # noqa: F401
from tinyfaces_tpu_torch.tools import (device_profile, eval_sweep_bench, jpegdct_ceiling,
                                       loader_bench, pipeline_profile, profile_model,
                                       serving_bench, train_bench, wire_stats)

torch.set_num_threads(2)

TINY = dict(stage_sizes=(1, 1, 1))
CPU = ["--device", "cpu"]


@pytest.mark.parametrize("kind", ["smooth", "natural", "texture", "graphics"])
def test_content_images_equal_the_jax_tool(kind):
    got = wire_stats.content_images(kind, 2, 64, 80, seed=1)
    want = jax_wire_stats.content_images(kind, 2, 64, 80, seed=1)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("kind,quality", [("texture", 90), ("graphics", 75), ("natural", 95)])
def test_measure_equals_the_jax_tool(kind, quality):
    imgs = wire_stats.content_images(kind, 2, 64, 96, seed=0)
    got = wire_stats.measure(imgs, 64, 96, quality)
    want = jax_wire_stats.measure(imgs, 64, 96, quality)
    assert set(got) == {"jpeg_Bpx", "nonzero_ac", "v3_Bpx", "v3_drop_pct", "v4_Bpx", "v4_drop_pct"}
    for k in got:
        assert got[k] == want[k], k


def test_wire_stats_cli(capsys):
    rows = wire_stats.main(CPU + ["--n", "1", "--h", "32", "--w", "48", "--json", "--psnr"])
    assert len(rows) == 16 and all(np.isfinite(r["v3_psnr_db"]) and np.isfinite(r["v4_psnr_db"])
                                   for r in rows.values())
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(rows))
    wire_stats.main(CPU + ["--n", "1", "--h", "32", "--w", "48"])
    out = capsys.readouterr().out.splitlines()
    assert "v4B/px" in out[0] and "worst v4 truncation" in out[-1]


def test_jpeg_writing_exits_naming_pil_without_it(monkeypatch):
    from tinyfaces_tpu_torch.utils.instruments import jpeg_bytes

    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(SystemExit, match="PIL"):
        jpeg_bytes([np.zeros((16, 16, 3), np.uint8)])
    with pytest.raises(SystemExit, match="PIL"):
        wire_stats.main(CPU + ["--n", "1", "--h", "16", "--w", "16"])


class _StubService:
    """Records each submitted input; every request is answered at once."""

    def __init__(self):
        self.seen = []

    def submit(self, x):
        from concurrent.futures import Future

        self.seen.append(x)
        fut = Future()
        fut.set_result(np.zeros((0, 5)))
        return fut


@pytest.mark.parametrize("load,duration,seed", [(16.0, 30.0, 0), (5.0, 12.0, 3)])
def test_arrival_schedule_equals_the_jax_tool(load, duration, seed, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)  # the schedule, not the waits
    inputs = list(range(5))
    port, jax_side = _StubService(), _StubService()
    got = serving_bench.run_level(port, inputs, load, duration, seed=seed)
    want = jax_serving_bench.run_level(jax_side, inputs, load, duration, seed=seed)
    offsets = np.cumsum(np.r_[0.0, np.random.default_rng(seed).exponential(1.0 / load, 10_000)])
    n = int(np.sum(offsets < duration))
    assert got["n"] == want["n"] == n and port.seen == jax_side.seen
    assert set(got) == set(want)


def _analytic_conv_flops(stages=(3, 4, 23), hw=(768, 1024), templates=25) -> float:
    """2 x multiply-adds of every convolution of the detector at input hw."""
    out = lambda n, k, s, p: (n + 2 * p - k) // s + 1  # noqa: E731
    total = 0.0

    def conv(cin, cout, k, s, p, h, w, groups=1):
        nonlocal total
        ho, wo = out(h, k, s, p), out(w, k, s, p)
        total += 2.0 * ho * wo * cout * (cin // groups) * k * k
        return ho, wo

    h, w = conv(3, 64, 7, 2, 3, *hw)
    h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)  # max pool
    cin, feats = 64, []
    for stage, (n, width) in enumerate(zip(stages, (64, 128, 256))):
        for i in range(n):
            s = 2 if stage > 0 and i == 0 else 1
            if s != 1 or cin != 4 * width:
                conv(cin, 4 * width, 1, s, 0, h, w)
            conv(cin, width, 1, 1, 0, h, w)
            h2, w2 = conv(width, width, 3, s, 1, h, w)
            conv(width, 4 * width, 1, 1, 0, h2, w2)
            h, w, cin = h2, w2, 4 * width
        feats.append((h, w, cin))
    c = 5 * templates
    conv(512, c, 1, 1, 0, *feats[1][:2])  # score_res3
    h4, w4 = conv(1024, c, 1, 1, 0, *feats[2][:2])  # score_res4
    total += 2.0 * h4 * w4 * c * 4 * 4  # depthwise ConvTranspose k4 s2: each input px x 16 taps
    return total


def test_profile_model_counts_the_convolutions():
    got = profile_model.forward_flops((768, 1024))
    want = _analytic_conv_flops()
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert profile_model.pyramid_flops() == pytest.approx(
        sum(_analytic_conv_flops(hw=hw) for hw in profile_model.PYRAMID_LEVELS), rel=0.01)
    # backward: about twice the forward (the first convolution's input needs no gradient)
    fwd = profile_model.forward_flops((500, 500), batch=12)
    assert 2.5 * fwd < profile_model.train_step_flops() < 3.0 * fwd


def test_peaks_and_profile_model_cli(capsys):
    assert profile_model.peak_tflops("NVIDIA H100 80GB HBM3", "bf16") == 989.0
    assert profile_model.peak_tflops("NVIDIA H100 80GB HBM3", "fp32") == 67.0
    assert profile_model.peak_tflops("Some Other GPU", "bf16") is None
    assert profile_model.achieved(1e12, 10.0, "Some Other GPU", "bf16")["share_of_peak"] is None
    out = profile_model.main(CPU + ["--batch", "1"])
    assert set(out["forward_flops"]) == {"192x256", "384x512", "768x1024", "1536x2048"}
    assert "no share printed" in capsys.readouterr().out


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_device_profile_parses_a_trace(tmp_path):
    window = {"ph": "X", "cat": "user_annotation", "name": device_profile.WINDOW, "ts": 0, "dur": 1000}
    k = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}  # noqa: E731
    events = [window,
              k("sm90_xmma_fprop_implicit_gemm_bf16", 100, 300),
              k("cudnn::bn_fw_inf_1C11_kernel_NCHW", 350, 100),  # overlaps the conv by 50 us
              k("void at::native::vectorized_elementwise_kernel<4, clamp_min>", 500, 100),
              k("nchwToNhwcKernel", 700, 50),
              k("Memcpy HtoD (Pinned -> Device)", 0, 50, "gpu_memcpy"),
              {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 900},
              k("cudaLaunchKernel", 10, 5, "cuda_runtime"), k("cudaGraphLaunch", 20, 5, "cuda_runtime"),
              k("cudaMemcpyAsync", 30, 5, "cuda_runtime"), k("cuLaunchKernel", 40, 5, "cuda_driver"),
              k("cudaStreamWaitEvent", 50, 5, "cuda_runtime"), k("cudaLaunchKernel", 1200, 5, "cuda_runtime")]
    r = device_profile.parse_trace(_trace(tmp_path, events), iters=2, batch=4, top=3)
    assert r["host_launches_per_batch"] == 2.0  # four launch calls in the window, over 2 batches
    assert r["device_ms"] == pytest.approx(0.6)
    assert r["device_ms_per_batch"] == pytest.approx(0.3)
    busy = 50 + 350 + 100 + 50  # union of [0,50) [100,450) [500,600) [700,750)
    assert r["busy_share"] == pytest.approx(busy / 1000) and r["idle_share"] == pytest.approx(1 - busy / 1000)
    assert r["class_share"] == pytest.approx({"convolution": 0.5, "batch_norm": 1 / 6, "elementwise": 1 / 6,
                                              "layout": 1 / 12, "copy": 1 / 12})
    assert [t["name"] for t in r["top_kernels"]][0].startswith("sm90_xmma_fprop")
    assert len(r["top_kernels"]) == 3 and r["launches_per_batch"] == 2.5
    assert device_profile.main(["--parse-only", str(tmp_path), "--iters", "2", "--batch", "4"]) == \
        device_profile.parse_trace(tmp_path, 2, 4)
    with pytest.raises(SystemExit, match="no CUDA event"):
        device_profile.parse_trace(_trace(tmp_path, [window, events[-1]]), iters=1, batch=1)


def test_device_profile_fails_without_cuda_events(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA event"):
        device_profile.main(CPU + ["--batch", "2", "--iters", "1", "--out-dir", str(tmp_path)],
                            hw=(64, 96), **TINY)
    assert (tmp_path / "trace.json").exists()


def test_train_bench_cpu(capsys, monkeypatch):
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):  # main sets them
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    plain = train_bench.main(CPU + ["--batch", "2", "--iters", "1"], **TINY)
    remat = train_bench.main(CPU + ["--batch", "2", "--iters", "1", "--remat"], **TINY)
    for out in (plain, remat):
        assert {"ms_per_step", "img_per_s", "losses", "k1_launches", "tflops", "card"} <= set(out)
        assert len(out["losses"]) == 2 and out["card"] == "cpu"
    np.testing.assert_allclose(remat["losses"], plain["losses"], rtol=1e-6)
    assert "+remat" in capsys.readouterr().out


def test_pipeline_profile_cpu():
    out = pipeline_profile.main(CPU + ["--batch", "2", "--reps", "1"], hw=(64, 96), **TINY)
    assert {"host_prep_ms", "h2d_ms", "device_compute_ms", "d2h_ms", "fetch_host_ms",
            "serial_ms", "pipelined"} <= set(out)
    assert sorted(out["pipelined"]) == [1, 2, 3, 4] and out["h2d_ms"] is None


@pytest.mark.parametrize("mode", ["device", "upload"])
def test_jpegdct_ceiling_cpu(mode):
    out = jpegdct_ceiling.main(CPU + ["--batch", "2", "--iters", "2", "--mode", mode],
                               hw=(64, 96), **TINY)
    assert out["mode"] == mode and out["img_per_s"] > 0 and out["clock"] == "host"


def test_serving_bench_cpu(capsys):
    rows = serving_bench.main(CPU + ["--loads", "20", "--duration", "0.5", "--max-batch", "2",
                                     "--size", "64x96", "--transfer", "rgb"], **TINY)
    assert len(rows) == 1
    assert {"offered_load", "achieved", "n", "p50_ms", "p95_ms", "p99_ms", "max_ms"} <= set(rows[0])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rows[0]


def test_eval_sweep_bench_cpu(tmp_path):
    out = eval_sweep_bench.main(CPU + ["--n", "4", "--eval-batch", "2", "--root", str(tmp_path)],
                                sizes=((64, 96), (48, 96)), **TINY)
    for mode in ("pipelined", "sync-batch", "per-image"):
        assert out[mode]["img_per_s"] > 0
        assert len(list((tmp_path / mode).rglob("*.txt"))) == 4
    assert out["pipelined_vs_sync"] > 0 and out["pipelined_vs_per_image"] > 0


def test_loader_bench_cpu(tmp_path):
    out = loader_bench.main(CPU + ["--images", "12", "--root", str(tmp_path)],
                            hw_range=((60, 100), (70, 110)))
    assert out["python"]["samples"] == out["native"]["samples"] == 12
    assert out["native_speedup"] > 0


def test_instruments_on_the_new_wires(tmp_path, capsys):
    """jpegdct_ceiling on the v4 wire, the serving bench on its default
    (yuv420, the JAX tool's) and the sweep bench on jpegdct4 and yuv420 run
    on the CPU."""
    out = jpegdct_ceiling.main(CPU + ["--batch", "2", "--iters", "2", "--transfer", "jpegdct4"],
                               hw=(64, 96), **TINY)
    assert out["transfer"] == "jpegdct4" and out["img_per_s"] > 0
    from tinyfaces_tpu_torch.data import jpegdct

    # 64x96 images sit in the 64x128 canvas bucket
    assert out["wire_MiB_per_batch"] == 2 * jpegdct.wire_layout_v4(64, 128)["__total__"] / 2**20
    rows = serving_bench.main(CPU + ["--loads", "20", "--duration", "0.5", "--max-batch", "2",
                                     "--size", "64x96"], **TINY)
    assert rows[0]["transfer"] == "yuv420" and rows[0]["n"] > 0
    for transfer in ("jpegdct4", "yuv420"):
        out = eval_sweep_bench.main(CPU + ["--n", "2", "--eval-batch", "2", "--transfer", transfer,
                                           "--root", str(tmp_path / transfer)],
                                    sizes=((64, 96),), **TINY)
        assert out["transfer"] == transfer and out["pipelined"]["img_per_s"] > 0
