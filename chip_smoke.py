"""Smoke run of omfs4d on an NVIDIA GPU: the main path, end to end.

    python chip_smoke.py [--seed N]   # one card
    python chip_smoke.py --multi      # four cards

One card, five phases, each printed on its own line:
  1. device: JAX must see a GPU; prints the card's name and power limit
     (nvidia-smi), the JAX version, XLA_FLAGS and the compile cache;
  2. composite parity at 512^2, 65,536 gaussians, K=256: the production
     composite's forward and VJP against `composite_reference` at float32
     ("highest" matmul precision);
  3. a synthetic 512^2, 60-frame case through `Pipeline.track`,
     `Pipeline.train` (200 iterations, a densify, checkpoints) and
     `Pipeline.render_surgery` (5 mm Le Fort I, 3 mm BSSO);
  4. the full-width train step (`AvatarTrainer._chunk_fn`) on the 512^2
     phase-2 state: compile time, recompiles in the timed window, peak
     device bytes;
  5. the last line of stdout, one JSON object naming the device.

`--multi` runs the four multi-card paths (frame-DP training, gaussian-
sharded training, the T-sharded tracker, tile-sharded rendering) on four
cards and the same work on one card, and compares them; nothing else.

Any failure raises: the script exits non-zero and prints no last line.
Everything runs in this one process.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

SIZE = 512
# forward bounds: max abs error; VJP bounds: abs <= GRAD_ATOL * max|grad|
# plus GRAD_RTOL * |grad| (the CPU tests' bounds; summation order only)
FWD_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3
IMAGE_ATOL = 1e-4
# float32 rounding: a gradient field whose entries all lie below EPS32 times
# the whole gradient's largest entry is zero up to rounding
EPS32 = float(np.finfo(np.float32).eps)


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def grad_report(name, got, ref):
    """Errors of one cotangent against the reference; raises past bounds."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    excess = float((err - GRAD_ATOL * scale - GRAD_RTOL * np.abs(ref)).max())
    ok = np.isfinite(got).all() and excess <= 0.0
    say("parity", grad=name, max_abs_err=float(err.max()),
        bound_abs=GRAD_ATOL * scale, rtol=GRAD_RTOL, excess=excess, ok=ok)
    if not ok:
        raise SystemExit(f"composite VJP for {name} outside its bounds")


def phase_device(count: int):
    from omfs4d.core.runtime import card_info, enable_compile_cache, require_gpu

    import jax

    cache = enable_compile_cache()
    devices = require_gpu(count)
    card = card_info()
    print(card, flush=True)
    say("device", platform=devices[0].platform,
        kind=repr(devices[0].device_kind), count=len(jax.devices()),
        jax=jax.__version__, xla_flags=repr(os.environ.get("XLA_FLAGS", "")),
        compile_cache=cache)
    return devices, card


def scene_binning(trainer, state, verts, cam):
    """Projected gaussians and tile lists of one frame, as the trainer's
    render builds them."""
    import jax

    from omfs4d.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d.ops.camera import project_gaussians
    from omfs4d.render.rasterize import bin_gaussians

    rc = trainer.render_cfg

    @jax.jit
    def run(g, v):
        means, rot, scales, opac, _ = bind_to_mesh(g, v, trainer.faces)
        cam_pos = -cam.w2c[:3, :3].T @ cam.w2c[:3, 3]
        cols = eval_colors(g, means, cam_pos)
        proj = project_gaussians(cam, means, rot, scales)
        binning = bin_gaussians(
            proj, opac, trainer.width, trainer.height, rc["tile"],
            rc["max_per_tile"], rc["max_tiles_per_gaussian"],
            small_tiles_per_gaussian=rc["small_tiles_per_gaussian"],
            large_frac=rc["large_frac"],
            two_class_min_n=rc["two_class_min_n"],
            large_min=rc["large_min"])
        return (proj["uv"], proj["conic"], cols, opac), binning

    return run(state.gaussians, verts)


def phase_parity(trainer, state, data, cam, seed: int):
    import jax
    import jax.numpy as jnp

    from omfs4d.render.pallas_kernels import composite_pallas
    from omfs4d.render.rasterize import composite_reference

    if not trainer.render_cfg["use_pallas"]:
        raise SystemExit("the GPU path did not choose the composite kernel")
    args, binning = scene_binning(trainer, state, data["verts"][0], cam)
    counts = np.asarray(binning.tile_counts)
    say("parity", tiles=counts.size, K=binning.tile_lists.shape[1],
        alive=int(np.asarray(state.gaussians.alive).sum()),
        mean_count=float(counts.mean()), max_count=int(counts.max()),
        overflow=int(binning.overflow))

    W = H = trainer.width
    rng = np.random.default_rng(seed)
    cot = (jnp.asarray(rng.normal(size=(H, W, 3)), jnp.float32),
           jnp.asarray(rng.normal(size=(H, W)), jnp.float32))

    def fwd_vjp(fn):
        f = lambda *a: fn(*a, binning, W, H, 16)
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cot)

    run_kernel = jax.jit(lambda: fwd_vjp(composite_pallas))
    (img_k, alp_k), g_k = run_kernel()
    with jax.default_matmul_precision("highest"):
        run_ref = jax.jit(lambda: fwd_vjp(composite_reference))
        (img_r, alp_r), g_r = run_ref()
    for name, got, ref in (("image", img_k, img_r), ("alpha", alp_k, alp_r)):
        err = float(jnp.max(jnp.abs(got - ref)))
        ok = bool(jnp.isfinite(got).all()) and err <= FWD_ATOL
        say("parity", out=name, max_abs_err=err, bound=FWD_ATOL, ok=ok)
        if not ok:
            raise SystemExit(f"composite {name} outside its bound")
    for name, a, b in zip(("uv", "conic", "colour", "opacity"), g_k, g_r):
        grad_report(name, a, b)


def phase_case(workdir: Path, seed: int, size: int = SIZE,
               n_vertices: int = 5143):
    """Synthetic case -> Pipeline.track -> .train -> .render_surgery."""
    from omfs4d.core.config import Config
    from omfs4d.io.dataset import FrameDataset
    from omfs4d.io.synthetic import make_synthetic_dataset
    from omfs4d.io.video import find_encoder, read_image
    from omfs4d.pipeline.runner import Pipeline
    from omfs4d.track.landmarks import detect_landmarks, save_landmarks

    T = 60
    t0 = time.perf_counter()
    case = make_synthetic_dataset(workdir / "case", n_frames=T, width=size,
                                  height=size, n_vertices=n_vertices,
                                  seed=seed, backend="auto")
    src = FrameDataset(case["path"], split="all")
    say("case", frames=len(src), size=size,
        synth_s=round(time.perf_counter() - t0, 1))

    # the dataset contract's frames, as the preprocess stage lays them out,
    # with landmarks of the case's own cameras; the tracker sees one
    # static camera (the middle of the orbit) and fits the head's motion
    frames_dir = workdir / "frames"
    (frames_dir / "images").mkdir(parents=True)
    for i in range(len(src)):
        (frames_dir / "images" / f"{i:05d}.png").write_bytes(
            (src.data_dir / src.frame_meta(i)["file_path"]).read_bytes())
    cams = [src.camera(i) for i in range(len(src))]
    lmk, valid = detect_landmarks(None, method="synthetic",
                                  model=case["model"], params=case["params"],
                                  cameras=cams)
    save_landmarks(frames_dir / "images" / "landmarks.npz", lmk, valid)

    cfg = Config()
    tc = cfg.track
    tc.steps_lmk_init_rigid = tc.steps_lmk_init_all = 40
    tc.steps_rgb_init_texture = tc.steps_rgb_init_all = 30
    tc.steps_rgb_init_offset = 20
    tc.steps_rgb_sequential = 2
    tc.steps_global = 30
    tc.epochs_global = 1
    cfg.train.iterations = 200
    cfg.train.densify_from = 50
    cfg.train.densify_interval = 100
    pipe = Pipeline(cfg, workdir / "work")
    pipe.model = case["model"]

    t0 = time.perf_counter()
    tracked = pipe.track(frames_dir, cams[T // 2], landmark_method="file")
    track_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model_dir = pipe.train(tracked, workdir / "model")
    train_s = time.perf_counter() - t0

    events = [json.loads(line) for line in
              (workdir / "work" / "events.jsonl").read_text().splitlines()]
    stages = [(e["stage"], e["loss"]) for e in events
              if e["event"] == "track_stage"]
    steps = [e for e in events if e["event"] == "train_step"]
    losses = [s for _, s in stages] + [e["loss"] for e in steps]
    say("case", track_stages=len(stages),
        track_losses=[round(v, 6) for _, v in stages],
        track_s=round(track_s, 1))
    say("case", train_iters=[e["iter"] for e in steps],
        train_losses=[round(e["loss"], 6) for e in steps],
        alive=int(steps[-1]["n_alive"]),
        checkpoints=sorted(p.name for p in
                           (model_dir / "checkpoints").iterdir()),
        train_s=round(train_s, 1))
    if not np.isfinite(losses).all():
        raise SystemExit("non-finite track or train loss")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise SystemExit("the training loss did not fall")
    if not (model_dir / "checkpoints").is_dir():
        raise SystemExit("no checkpoint was written")

    encoder = find_encoder()
    t0 = time.perf_counter()
    result = pipe.render_surgery(
        model_dir, tracked,
        workdir / "prediction.mp4" if encoder else None,
        lefort_mm=5.0, bsso_mm=3.0)
    renders = sorted(Path(result["renders_dir"]).glob("*.png"))
    frames = np.stack([read_image(p) for p in renders]).astype(np.float32)
    say("case", predicted_frames=len(renders), encoder=encoder,
        video=result["video"], frame_std=float(frames.std()),
        render_s=round(time.perf_counter() - t0, 1))
    if not (np.isfinite(frames).all() and frames.std() > 1.0):
        raise SystemExit("predicted frames are constant or not finite")


def phase_train_step(trainer, state, data, device, card: str, steps: int):
    import jax
    import jax.numpy as jnp

    from omfs4d.core.runtime import CompileCounter

    chunk = 25
    rng = np.random.default_rng(0)
    idxs = jnp.asarray(rng.integers(0, data["images"].shape[0],
                                    size=(chunk, 1)), jnp.int32)
    t0 = time.perf_counter()
    state, ms = trainer._chunk_fn(state, data, idxs)
    jax.block_until_ready(ms["loss"])
    compile_s = time.perf_counter() - t0
    compiles = CompileCounter()
    n_chunks = max(-(-steps // chunk), 1)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, ms = trainer._chunk_fn(state, data, idxs)
    jax.block_until_ready(ms["loss"])
    step_ms = (time.perf_counter() - t0) / (n_chunks * chunk) * 1e3
    losses = np.asarray(ms["loss"])
    peak = device.memory_stats()["peak_bytes_in_use"]
    say("train_step", steps=n_chunks * chunk, setup_compile_s=compile_s,
        recompiles=compiles.count, peak_bytes_in_use=peak,
        step_ms=step_ms, card=repr(card),
        capacity=int(state.gaussians.capacity))
    if compiles.count:
        raise SystemExit(f"{compiles.count} recompiles in the timed window")
    if not np.isfinite(losses).all():
        raise SystemExit("non-finite training loss")


def device_bytes(devices):
    """Bytes in use on each device (0 where the backend keeps no
    statistics, as the CPU's does not)."""
    return [(d.memory_stats() or {}).get("bytes_in_use", 0) for d in devices]


def new_bytes(before, devices):
    """Bytes each device gained since `before`: where a four-card run's
    results landed (all on device 0 would mean it did not spread)."""
    return [a - b for a, b in zip(device_bytes(devices), before)]


def compare(path: str, got: dict, ref: dict, exact_atol=None) -> bool:
    """A 4-card path's results against its 1-card twin, one line each.

    Images: max abs error <= `exact_atol`.  Losses and gradients: the
    phase-2 bounds, abs <= GRAD_ATOL * max|field| + GRAD_RTOL * |ref|,
    each field held to its own largest entry.  The absolute part is floored
    at float32 rounding of the whole gradient's largest entry, which binds
    only a field that is zero up to rounding (the rotation gradient of
    isotropic gaussians); the floor is printed beside each field's max.
    Returns whether all passed; every entry is reported."""
    got = {k: np.asarray(v, np.float64) for k, v in got.items()}
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    grads = [k for k in ref if k != "loss"]
    floor = EPS32 * max((float(np.abs(ref[k]).max()) for k in grads),
                        default=0.0)
    all_ok = True
    for k in ref:
        err = np.abs(got[k] - ref[k])
        if exact_atol is not None:
            ok = bool(np.isfinite(got[k]).all() and err.max() <= exact_atol)
            say(path, out=k, max_abs_err=float(err.max()), bound=exact_atol,
                ok=ok)
        else:
            field_max = float(np.abs(ref[k]).max())
            bound_abs = GRAD_ATOL * field_max
            if k != "loss":
                bound_abs = max(bound_abs, floor)
            excess = float((err - bound_abs
                            - GRAD_RTOL * np.abs(ref[k])).max())
            ok = bool(np.isfinite(got[k]).all() and excess <= 0.0)
            say(path, out=k, max_abs_err=float(err.max()),
                field_max=field_max, floor=None if k == "loss" else floor,
                bound_abs=bound_abs, rtol=GRAD_RTOL, excess=excess, ok=ok)
        all_ok &= ok
    return all_ok


def run_multi(devices, seed: int):
    """Each multi-card path on four cards against the same work on one."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from omfs4d.core.config import TrackConfig
    from omfs4d.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d.parallel.shard import (avatar_loss_gaussian_sharded,
                                       rasterize_tile_sharded)
    from omfs4d.track.fitter import FRAME_KEYS, FlameTracker
    from omfs4d.train.scene import build_train_scene
    from omfs4d.train.trainer import float_fields, with_floats

    four, one = devices[:4], devices[:1]
    B = len(four)

    # frame-DP training: one step over a 4-frame batch, sharded over a
    # `data` axis, against the same step unsharded
    out = {}
    for label, mesh in (("4", Mesh(np.asarray(four), ("data",))),
                        ("1", None)):
        model, cam, trainer, state, data = build_train_scene(
            seed=seed, batch_frames=B, mesh=mesh)
        before = device_bytes(four)
        state, m = trainer._step_fn(state, data, jnp.arange(B, dtype=jnp.int32))
        out[label] = (float(m["loss"]), np.asarray(state.grad_accum),
                      new_bytes(before, four),
                      len(state.gaussians.mu_local.sharding.device_set))
    say("frame_dp", loss_4=out["4"][0], loss_1=out["1"][0],
        state_devices_4=out["4"][3], new_bytes_4=out["4"][2])
    failed = []
    if not compare("frame_dp", *({"loss": out[k][0],
                                  "screen_grad_norms": out[k][1]}
                                 for k in ("4", "1"))):
        failed.append("frame_dp")

    g = state.gaussians
    verts = data["verts"]
    W = H = trainer.width

    # tile-sharded rendering with the composite kernel per shard
    means, rot, scales, opac, _ = bind_to_mesh(g, verts[0], trainer.faces)
    cols = eval_colors(g, means, -cam.w2c[:3, :3].T @ cam.w2c[:3, 3])
    imgs = {}
    for label, devs in (("4", four), ("1", one)):
        mesh = Mesh(np.asarray(devs), ("tile",))
        before = device_bytes(four)
        img, aux = jax.jit(lambda *a: rasterize_tile_sharded(
            *a, cam, W, H, mesh=mesh, max_per_tile=256,
            use_pallas=True))(means, rot, scales, opac, cols)
        imgs[label] = (np.asarray(img), new_bytes(before, four),
                       len(img.sharding.device_set))
    say("tile_sharded", image_devices_4=imgs["4"][2],
        new_bytes_4=imgs["4"][1])
    if not compare("tile_sharded", {"image": imgs["4"][0]},
                   {"image": imgs["1"][0]}, IMAGE_ATOL):
        failed.append("tile_sharded")

    # gaussian-sharded training loss and gradients; both sides must
    # composite the same entries: K=2048 so no tile list overflows, and a
    # large-window budget of every gaussian (large_frac=0.5 of a slice
    # buffer of 2N) so neither spills — at the default budget, spills
    # differ by design, since each slice holds the budget of one card
    gt = data["images"][0].astype(jnp.float32) / 255.0
    fp = float_fields(g)
    res = {}
    for label, devs in (("4", four), ("1", one)):
        mesh = Mesh(np.asarray(devs), ("gauss",))
        shard = NamedSharding(mesh, P("gauss"))

        def loss(fp, mesh=mesh):
            return avatar_loss_gaussian_sharded(
                with_floats(g, fp), verts[0], trainer.faces, cam, gt,
                mesh=mesh, max_per_tile=2048, large_frac=0.5,
                use_pallas=True, return_aux=True)

        fp_s = jax.device_put(fp, shard)
        before = device_bytes(four)
        (l, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            fp_s)
        res[label] = (float(l), int(aux["overflow"]) + int(aux["spilled"]),
                      {k: np.asarray(v) for k, v in grads.items()},
                      len(grads["mu_local"].sharding.device_set),
                      new_bytes(before, four))
    say("gauss_sharded", loss_4=res["4"][0], loss_1=res["1"][0],
        overflow_spilled_4=res["4"][1], overflow_spilled_1=res["1"][1],
        grad_devices_4=res["4"][3], new_bytes_4=res["4"][4])
    if res["4"][1] or res["1"][1]:
        raise SystemExit("gauss_sharded: a tile list overflowed or a "
                         "gaussian spilled, so the two runs composite "
                         "different entries")
    if res["4"][3] != len(four):
        raise SystemExit("gaussian-sharded gradients are not spread over "
                         "the four cards")
    if not compare("gauss_sharded", *({"loss": res[k][0], **res[k][2]}
                                      for k in ("4", "1"))):
        failed.append("gauss_sharded")

    # T-sharded tracker: landmark + photometric loss and gradients over a
    # 60-frame sequence with the frame axis on a `data` mesh axis
    T = 60
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    lmk = jnp.asarray(W / 2 + rng.normal(0, 20, (T, 68, 2)), jnp.float32)
    valid = jnp.ones((T,), bool)
    idx = jnp.asarray(rng.integers(0, T, (4,)), jnp.int32)
    tcfg = TrackConfig(rgb_downsample=2)
    texture = jnp.asarray(rng.normal(0, 1, (tcfg.texture_res,
                                            tcfg.texture_res, 3)),
                          jnp.float32)
    res = {}
    for label, mesh in (("4", Mesh(np.asarray(four), ("data",))),
                        ("1", None)):
        tracker = FlameTracker(model, tcfg, cam, (W, H), mesh=mesh)
        p = tracker.init_params(T)
        p["texture"] = texture
        p["jaw_pose"] = p["jaw_pose"] + 0.05
        prepped = tracker._prep_frames(frames)

        def loss(p, tracker=tracker, mesh=mesh):
            if mesh is not None:
                s = NamedSharding(mesh, P("data"))
                p = {k: jax.lax.with_sharding_constraint(v, s)
                     if k in FRAME_KEYS else v for k, v in p.items()}
            return (tracker._regularizers(p)
                    + tracker._landmark_loss(p, lmk, valid)
                    + tracker._photometric_loss(p, prepped, idx))

        before = device_bytes(four)
        l, grads = jax.jit(jax.value_and_grad(loss))(p)
        res[label] = (float(l), {k: np.asarray(v) for k, v in grads.items()},
                      new_bytes(before, four))
    say("tracker_T_sharded", frames=T, loss_4=res["4"][0],
        loss_1=res["1"][0], new_bytes_4=res["4"][2])
    keys = ("expr", "jaw_pose", "rotation", "translation", "texture")
    if not compare("tracker_T_sharded", *(
            {"loss": res[k][0], **{f: res[k][1][f] for f in keys}}
            for k in ("4", "1"))):
        failed.append("tracker_T_sharded")
    if failed:
        raise SystemExit(f"4 cards and 1 differ beyond the bounds: {failed}")


def run_one_card(args):
    devices, card = phase_device(1)

    from omfs4d.train.scene import build_train_scene

    _, cam, trainer, state, data = build_train_scene(seed=args.seed)
    phase_parity(trainer, state, data, cam, args.seed)
    with tempfile.TemporaryDirectory(prefix="omfs4d_smoke_") as tmp:
        phase_case(Path(tmp), args.seed)
    phase_train_step(trainer, state, data, devices[0], card, steps=50)
    return devices


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="the four-card paths against one card, only")
    args = ap.parse_args()

    if args.multi:
        devices, _ = phase_device(4)
        run_multi(devices, args.seed)
    else:
        devices = run_one_card(args)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
