"""Entry points refuse to measure without a GPU, fail loudly, and place the
compile cache from outside; no module is left on the TPU kernel API."""

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, cwd=REPO, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    return '"ok"' not in proc.stdout


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    proc = _run([os.path.join(REPO, script)])
    assert proc.returncode != 0
    assert _no_result(proc)
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert proc.returncode != 0
    assert _no_result(proc)


def test_failing_phase_exits_nonzero(monkeypatch, capsys):
    import chip_smoke

    def broken(count):
        raise chip_smoke.SmokeFailure("phase device broke")

    monkeypatch.setattr(chip_smoke, "phase_device", broken)
    assert chip_smoke.run([]) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "phase device broke" in out.err


_CACHE_PROBE = ("import jax; from cswin_unet_tpu.utils.compile_cache import "
                "enable_compile_cache as e; d = e(); "
                "print(d); print(jax.config.jax_compilation_cache_dir)")


def test_cache_dir_from_environment(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    proc = _run(["-c", _CACHE_PROBE], **env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_cache_dir_default_is_repo_jax_cache():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert proc.stdout.split() == [want, want]


def test_no_module_uses_the_tpu_kernel_api():
    pattern = re.compile(r"pallas[./]tpu|pltpu|default_backend\(\) == .cpu.|attn_impl")
    this = os.path.abspath(__file__)
    hits = []
    for root, dirs, files in os.walk(REPO):
        dirs[:] = [d for d in dirs if not d.startswith(".") and d != "__pycache__"]
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".py") and path != this:
                with open(path) as f:
                    hits += [f"{path}:{i}" for i, line in enumerate(f, 1)
                             if pattern.search(line)]
    assert not hits, hits
