"""Device set-up rules: compile cache, pod card choice, device-count and
peak-table refusals, and the smoke script's refusal of a CPU backend."""

import importlib.util
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is exactly the cache directory;
    otherwise the cache is the fixed .jax_cache/ of the checkout."""
    from longcallr_tpu.utils import device as D

    prev = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert D.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    if env_dir is None:
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("pid,n_gpus,env,want", [
    (0, 4, {}, [0]),
    (5, 4, {}, [1]),                                  # second host of a pod
    (2, 4, {"CUDA_VISIBLE_DEVICES": "2"}, None),      # launcher chose
    (1, 0, {}, None),                                 # host without cards
])
def test_pod_local_device_ids(pid, n_gpus, env, want):
    """Each pod process opens one card of its host, never its peers'."""
    from longcallr_tpu.parallel.multihost import pod_local_device_ids
    assert pod_local_device_ids(pid, n_gpus, environ=env) == want


def test_dryrun_multichip_refuses_too_few_devices():
    """No quiet move to other devices: too few devices of the default
    platform is an error."""
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    with pytest.raises(RuntimeError, match="needs"):
        ge.dryrun_multichip(len(jax.devices()) + 1)


def test_device_peaks_lookup():
    """Peaks come from a table keyed by device kind; an unknown kind is an
    error, never a default."""
    sys.path.insert(0, ROOT)
    from bench import DEVICE_PEAKS, device_peaks

    for kind, peaks in DEVICE_PEAKS.items():
        assert device_peaks(kind)["hbm_bytes_per_s"] > 0
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("TPU v5 lite")


def test_chip_smoke_refuses_cpu_backend(tmp_path):
    """On a CPU backend the smoke exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "no GPU" in p.stderr
