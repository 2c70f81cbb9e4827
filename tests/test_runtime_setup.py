"""Process-level setup: the compile-cache rule, the index builder choice
and the `[device]` report."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(tmp_path, extra_env):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra_env)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, siga_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


@pytest.mark.parametrize("set_env", [False, True])
def test_compile_cache_dir_rule(tmp_path, set_env):
    if set_env:
        # the variable is honoured: the program sets no other directory
        want = str(tmp_path / "elsewhere")
        assert _cache_dir(tmp_path, {"JAX_COMPILATION_CACHE_DIR": want}) == want
    else:
        # otherwise one fixed path inside the checkout, whatever the cwd
        assert _cache_dir(tmp_path, {}) == os.path.join(ROOT, ".jax_cache")


@pytest.mark.parametrize(
    "n_chars, use_device, cap, want",
    [
        (1000, True, None, "device"),
        (20_000_000, True, None, "device"),
        (20_000_001, True, None, "host"),
        (1000, False, None, "numpy"),
        (5000, True, "4096", "host"),
    ],
)
def test_choose_builder(monkeypatch, n_chars, use_device, cap, want):
    from siga_tpu.index import sa

    if cap is not None:
        monkeypatch.setenv("SIGA_SA_DEVICE_MAX", cap)
    assert sa.choose_builder(n_chars, use_device) == want


def test_index_names_its_builder(tmp_path):
    """`siga index` says on stderr which builder ran, and a device build
    reports its device; the host beyond-the-cap build gives the same bytes."""
    import random

    rng = random.Random(4)
    genome = "".join(rng.choice("ACGT") for _ in range(3000))
    with open(tmp_path / "r.fa", "w") as f:
        for i in range(0, 2900, 23):
            f.write(f">r{i}\n{genome[i:i + 90]}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for name, extra in (("dev", {}), ("cap", {"SIGA_SA_DEVICE_MAX": "100"})):
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "siga"), "index", "-p", name, "r.fa"],
            env=dict(env, **extra), cwd=str(tmp_path), capture_output=True,
            text=True, check=True,
        ).stderr
        runs[name] = out
    assert "[index] builder: device," in runs["dev"]
    assert "[index] builder: host," in runs["cap"]
    dev = [json.loads(l[len("[device] "):]) for l in runs["dev"].splitlines()
           if l.startswith("[device] ")]
    assert len(dev) == 1 and dev[0]["stage"] == "index" and dev[0]["platform"] == "cpu"
    assert dev[0]["native"] is True
    assert not any(l.startswith("[device] ") for l in runs["cap"].splitlines())
    for ext in (".bwt", ".sai", ".rbwt", ".rsai"):
        assert (tmp_path / f"dev{ext}").read_bytes() == (tmp_path / f"cap{ext}").read_bytes()
