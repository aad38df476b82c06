"""Entry-point set-up: the GPU requirement, the compile cache, and the
host formats the main path writes (PNG frames, npz checkpoints)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(cwd), env.get("PYTHONPATH", "")) if p)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_refuse_a_cpu(script):
    """Without a GPU both measurement entry points exit non-zero before any
    work and print no result line."""
    r = _run([script], REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {"PYTHONPATH": ""}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=dict(os.environ, JAX_PLATFORMS="cpu", **env),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_require_gpu_raises_on_cpu():
    from omfs4d.core.runtime import require_gpu

    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_compile_cache_default_is_in_the_checkout(monkeypatch):
    import jax

    from omfs4d.core import runtime

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_the_variable(monkeypatch, tmp_path):
    import jax

    from omfs4d.core import runtime

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    # nothing is set in code when the variable names the directory
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 31)])
def test_png_roundtrip(tmp_path, shape):
    from omfs4d.io.png import read_png, write_png
    from omfs4d.io.video import read_image, write_image

    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "a.png", img)
    assert np.array_equal(read_png(tmp_path / "a.png").squeeze(-1)
                          if img.ndim == 2 else read_png(tmp_path / "a.png"),
                          img)
    write_image(tmp_path / "b.png", img)
    back = read_image(tmp_path / "b.png")
    assert back.shape == shape[:2] + (3,)
    assert np.array_equal(back if img.ndim == 3 else back[..., 0], img)


def test_png_reads_every_row_filter():
    """Other encoders choose a filter per row; all five must decode."""
    import struct
    import zlib

    from omfs4d.io.png import SIGNATURE, _chunk, decode_png

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (10, 7, 3)).astype(np.int64)
    h, w, bpp = 10, 7, 3
    rows = img.reshape(h, -1)
    raw = []
    for y in range(h):
        f, cur = y % 5, rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        raw.append(np.concatenate([[f], (cur - pred) % 256]))
    data = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(
                np.asarray(raw, np.uint8).tobytes()))
            + _chunk(b"IEND", b""))
    assert np.array_equal(decode_png(data), img.astype(np.uint8))


def test_npz_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from omfs4d.train.checkpoints import STATE_FILE, restore_state, save_state

    state = {"a": jnp.arange(6.0).reshape(2, 3), "b": (jnp.int32(4), None),
             "c": [jnp.ones((3,), bool)]}
    path = save_state(tmp_path / "iter_0000010", state)
    assert (path / STATE_FILE).is_file()
    back = restore_state(path, template=state)
    assert np.array_equal(back["a"], state["a"])
    assert int(back["b"][0]) == 4 and back["b"][1] is None
    assert back["c"][0].dtype == bool and back["c"][0].all()
    with pytest.raises(ValueError, match="template"):
        restore_state(path, template={"a": state["a"]})
