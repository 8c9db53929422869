"""Set-up that every entry point shares: the compile-cache location, the
generated Cornell image maps, and the GPU requirement of bench.py and
chip_smoke.py."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tracer import compile_cache
from tracer.io.ppm import load_ppm
from tracer.scenes import maps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("path", sorted(maps.MAPS))
def test_generated_map_is_deterministic(path, tmp_path):
    """Two builds give the same bytes; the file is a SIZE^2 RGB PPM that
    the loader reads back, with real content."""
    a = maps.ensure(path, str(tmp_path / "a"))
    b = maps.ensure(path, str(tmp_path / "b"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    img = load_ppm(a)
    assert img.shape == (maps.SIZE, maps.SIZE, 3) and img.dtype == np.uint8
    assert img.std() > 5.0
    np.testing.assert_array_equal(img, maps.generate(path))
    if "normalMaps" in path:   # tangent-space normals point out (+z)
        assert img[..., 2].min() > 127


def test_cornell_loads_generated_maps():
    from tracer.scene.device import compile_scene
    from tracer.scenes import zoo

    sb = zoo.setup_cornell_box()
    assert all(t is not None and t.shape == (maps.SIZE, maps.SIZE, 3)
               for t in sb.textures + sb.normal_maps)
    scene = compile_scene(sb)
    n = maps.SIZE * maps.SIZE
    assert scene.tex_data.shape[0] == 1 + 2 * n
    assert scene.nm_data.shape[0] == 1 + 3 * n


def test_bench_and_smoke_refuse_cpu():
    import bench
    import chip_smoke

    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu()


def test_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository exits non-zero and
    prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
