"""The last JAX tools' counterparts on the CPU: tools.h2d_probe,
tools.prewarm_cache and tools.kernel_selftest.

The probe and the self-test measure a card: `--device cpu` exits, and so
does `--device cuda` without a card, as the other instruments do. The
prewarm builds the two host libraries into an empty build directory (and
finds them cached the second time); with a card it also builds K1.
"""

import numpy as np
import pytest
import torch

from tinyfaces_tpu_torch.data import jpegdct, native
from tinyfaces_tpu_torch.tools import h2d_probe, kernel_selftest, prewarm_cache
from tinyfaces_tpu_torch.utils import cuda_build


@pytest.mark.parametrize("tool,message", [(h2d_probe, "link"), (kernel_selftest, "on a card")])
def test_card_tools_refuse_the_cpu(tool, message, monkeypatch):
    with pytest.raises(SystemExit, match=message):
        tool.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        tool.main(["--device", "cuda"])


def test_probe_payloads():
    data = h2d_probe.payloads(2)
    assert set(data) == {"noise", "zeros", "photo"}
    for arr in data.values():
        assert arr.dtype == np.uint8 and arr.shape == (2 * h2d_probe.MIB,)
    assert not data["zeros"].any() and len(np.unique(data["noise"])) == 255
    row = np.linspace(0, 255, 1024)
    np.testing.assert_array_equal(data["photo"][:1024], ((row[0] + row) / 2).astype(np.uint8))
    assert h2d_probe._host(data["noise"], False, torch.float32).shape == (2 * h2d_probe.MIB // 4,)


def test_selftest_scene_is_the_jax_tools():
    gt, valid = kernel_selftest.scene(12, 192)
    counts = valid.sum(1)
    assert gt.shape == (12, 192, 4) and ((counts >= 5) & (counts < 60)).all()
    assert (gt[valid][:, 2:] > gt[valid][:, :2]).all() and not gt[~valid].any()
    rng = np.random.default_rng(0)
    n = int(rng.integers(5, 60))
    assert counts[0] == n and gt[0, 0, 0] == np.float32(rng.uniform(0, 450, n)[0])


def test_prewarm_builds_the_host_libraries(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "torch_ext")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(jpegdct, "_lib", None)
    first = prewarm_cache.main(["--device", "cpu"])
    assert [r["name"] for r in first["libraries"]] == ["tinyfaces_native", "jpeg_dct"]
    assert all(r["compiled"] and (tmp_path / "torch_ext" / r["library"]).exists()
               for r in first["libraries"])
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(jpegdct, "_lib", None)
    second = prewarm_cache.main(["--device", "cpu"])
    assert not any(r["compiled"] for r in second["libraries"])
    assert "jpeg_dct: cached" in capsys.readouterr().out
    assert "dense_assignment" in prewarm_cache.builds(True)
