"""Avatar training/render throughput on one NVIDIA GPU.

    python bench.py [--reference] [--iters N]

Prints progress to stderr and, as the last line of stdout, one JSON object:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {...}, "extra": {...}}

Baseline (BASELINE.md): the reference trains 30K iterations in ~30 min on an
RTX 4070 Ti at 512 resolution => 16.7 train iters/sec.  vs_baseline is the
ratio of this framework's one-card chunked train throughput to that number.

There is no CPU mode: without a GPU the script exits non-zero before any
work, and any failure inside a phase ends the run with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BASELINE_TRAIN_ITERS_PER_SEC = 30_000 / (30 * 60)   # ~16.7 (app.py:1347)

# Published dense peaks per device kind, as JAX names the device.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part, without
# sparsity), at the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}
# They are reported beside the result but no share of them is: XLA's cost
# model leaves out the Pallas composite, so FLOP and byte counts per step
# must come from a trace first.


def _mark(msg):
    print(f"# bench: {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", action="store_true",
                    help="composite with the XLA reference, not the kernel")
    ap.add_argument("--iters", type=int, default=200,
                    help="timed train steps")
    args = ap.parse_args()

    from omfs4d.core.runtime import (CompileCounter, card_info,
                                     enable_compile_cache, require_gpu)
    from omfs4d.train.scene import (MAX_PER_TILE, N_ALIVE, N_FRAMES, SIZE,
                                    build_train_scene)

    import jax
    import jax.numpy as jnp

    cache_dir = enable_compile_cache()
    dev = require_gpu()[0]
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for {dev.device_kind!r}; add "
                         "them with their source to PEAKS")
    peaks = PEAKS[dev.device_kind]
    card = card_info()
    _mark(f"card: {card}; kind={dev.device_kind} count={len(jax.devices())} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} cache={cache_dir}")

    model, cam, trainer, state, data = build_train_scene(
        "never" if args.reference else "always")
    kernel = bool(trainer.render_cfg["use_pallas"])
    compiles = CompileCounter()
    T = N_FRAMES
    rng = np.random.default_rng(1)

    # ── chunked training (the trainer's production loop) ──────
    C = 50
    idxs = jnp.asarray(rng.integers(0, T, size=(C, 1)), jnp.int32)
    t0 = time.perf_counter()
    state, ms = trainer._chunk_fn(state, data, idxs)
    jax.block_until_ready(ms["loss"])
    compile_train = time.perf_counter() - t0
    n_chunks = max(args.iters // C, 2)
    before = compiles.count
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, ms = trainer._chunk_fn(state, data, idxs)
    jax.block_until_ready(ms["loss"])
    train_ips = n_chunks * C / (time.perf_counter() - t0)
    recompiles = compiles.count - before
    loss = np.asarray(ms["loss"])
    if not np.isfinite(loss).all():
        raise SystemExit("non-finite training loss")
    _mark(f"train_ips={train_ips} compile={compile_train:.1f}s")

    # ── render-only frames/sec ───────────────────────────────
    verts = data["verts"]
    t0 = time.perf_counter()
    img = trainer.render_frame(state, verts[0], cam)
    jax.block_until_ready(img)
    compile_render = time.perf_counter() - t0
    n_render = args.iters
    before = compiles.count
    t0 = time.perf_counter()
    for i in range(n_render):
        img = trainer.render_frame(state, verts[i % T], cam)
    jax.block_until_ready(img)
    render_fps = n_render / (time.perf_counter() - t0)
    recompiles += compiles.count - before
    if not np.isfinite(np.asarray(img)).all():
        raise SystemExit("non-finite render")
    _mark(f"render_fps={render_fps}")

    # ── FLAME landmark fit iters/sec (T=150 frames) ──────────
    import optax

    from omfs4d.core.config import TrackConfig
    from omfs4d.track.fitter import FlameTracker

    Tt = 150
    tracker = FlameTracker(model, TrackConfig(n_shape=100, n_expr=50,
                                              photometric=False),
                           cam, (SIZE, SIZE))
    p = tracker.init_params(Tt)
    lmk = jnp.full((Tt, model.lmk_faces_idx.shape[0], 2), SIZE / 2.0)
    valid = jnp.ones((Tt,), bool)
    opt = tracker._make_opt()
    FIT_CHUNK = 25

    def fit_chunk(p, opt_state):
        def body(carry, _):
            q, os_ = carry
            loss, grads = jax.value_and_grad(
                lambda q: tracker._landmark_loss(q, lmk, valid)
                + tracker._regularizers(q))(q)
            updates, os_ = opt.update(grads, os_, q)
            return (optax.apply_updates(q, updates), os_), loss

        (p, opt_state), losses = jax.lax.scan(
            body, (p, opt_state), None, length=FIT_CHUNK)
        return p, opt_state, losses[-1]

    fit_jit = jax.jit(fit_chunk, donate_argnums=(0, 1))
    p, opt_state, fit_loss = fit_jit(p, opt.init(p))
    jax.block_until_ready(fit_loss)
    n_fit = max(args.iters // FIT_CHUNK, 4)
    before = compiles.count
    t0 = time.perf_counter()
    for _ in range(n_fit):
        p, opt_state, fit_loss = fit_jit(p, opt_state)
    jax.block_until_ready(fit_loss)
    flame_ips = n_fit * FIT_CHUNK / (time.perf_counter() - t0)
    recompiles += compiles.count - before
    if not np.isfinite(float(fit_loss)):
        raise SystemExit("non-finite FLAME fit loss")
    _mark(f"flame_fit_ips={flame_ips}")

    peak_bytes = dev.memory_stats()["peak_bytes_in_use"]

    result = {
        "metric": f"3dgs_train_iters_per_sec@{SIZE}",
        "value": train_ips,
        "unit": "iter/s",
        "vs_baseline": train_ips / BASELINE_TRAIN_ITERS_PER_SEC,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "extra": {
            "render_fps": render_fps,
            "flame_fit_iters_per_sec": flame_ips,
            "composite": "kernel" if kernel else "reference",
            "n_gaussians": N_ALIVE,
            "capacity": int(state.gaussians.capacity),
            "max_per_tile": MAX_PER_TILE,
            "resolution": SIZE,
            "compile_s": {"train_chunk": compile_train,
                          "render": compile_render},
            "recompiles_in_window": recompiles,
            "peak_bytes_in_use": peak_bytes,
            "peaks": peaks,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
        },
    }
    if recompiles:
        raise SystemExit(f"{recompiles} recompiles inside the timed windows")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
