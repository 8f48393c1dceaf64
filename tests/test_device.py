"""The measurement layer's rules that hold without a card: the peak
table, the bytes-per-site model, the busy-time reduction, the
compile-cache directory rule and chip_smoke's refusal to run off-GPU."""

import os
import subprocess
import sys

import pytest

from lbmdem.utils import compile_cache, device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_peak_table_known_device():
    pk = device.peak("NVIDIA H100 80GB HBM3")
    assert pk["hbm_gbs"] == 3350.0 and pk["f32_tflops"] == 67.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peak"):
        device.peak(kind)


def test_bytes_per_site_model():
    # 9 populations read once + written once; coupled adds the 3-plane
    # f32 solid stack once
    assert device.bytes_per_site(False) == 72
    assert device.bytes_per_site(True) == 84
    assert device.bytes_per_site(False, "bfloat16") == 36
    assert device.bytes_per_site(True, "bfloat16") == 48


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 12), (20, 25)], 17.0),   # overlap counted once
    ([(20, 25), (0, 10), (2, 3)], 15.0),    # unsorted, nested
])
def test_busy_time_union(spans, want):
    assert device.union_length(spans) == want


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def _cache_probe(env):
    code = (
        "import jax, jax.numpy as jnp\n"
        "from lbmdem.utils.compile_cache import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "jax.jit(lambda x: jnp.sin(x) * 2.0 + x)(jnp.ones(8)).block_until_ready()\n"
        "print(d)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="true",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=REPO, **env)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it, the helper sets
    nothing, and compiled programs land there."""
    want = str(tmp_path / "cache")
    got, cfg_dir = _cache_probe({"JAX_COMPILATION_CACHE_DIR": want})
    assert got == cfg_dir == want
    assert os.listdir(want), "nothing was cached in the env directory"


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Unset: one fixed directory inside the checkout, listed in
    .gitignore - never derived from a temporary name, pid or time."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    import jax

    before = jax.config.jax_compilation_cache_dir
    try:
        d = compile_cache.enable_compile_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        assert compile_cache.enable_compile_cache() == d  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_chip_smoke_refuses_cpu():
    """On the CPU chip_smoke exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo:
    non-zero exit, no result line."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
