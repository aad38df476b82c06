"""Post-surgical prediction rendering: modified params -> frames -> MP4.

End-to-end parity with the reference's render path
(ref: render_surgery.py:245-362, 412-449), in-process instead of via a
GaussianAvatars subprocess:

  * picks the highest `point_cloud/iteration_*` unless pinned;
  * clears stale renders, writes `train/ours_N/renders/*.png` (+ gt/);
  * optional deterministic frame export; stitches H.264/MP4 (ffmpeg or
    OpenCV) unless no output video is asked for.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from omfs4d.core.logging import get_logger
from omfs4d.io.dataset import FrameDataset
from omfs4d.io.video import stitch_video, write_image
from omfs4d.models.flame import FlameModel, flame_forward
from omfs4d.predict.surgery import (
    choose_rig_mode,
    compute_offset,
    create_modified_dataset,
    export_deterministic_frames,
    load_deformation_map,
)
from omfs4d.render.rasterize import render_avatar_frame
from omfs4d.train.checkpoints import latest_iteration, load_point_cloud

log = get_logger("render_surgery")


def render_dataset_frames(
    flame_model: FlameModel,
    gaussians,
    data_dir: str | Path,
    out_renders: str | Path,
    out_gt: str | Path | None = None,
    split: str = "train",
    backend: str = "auto",
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    white_background: bool = True,
    n_tile: int = 1,
    large_frac: float = 1.0,
) -> Path:
    """Render every frame of a dataset split with the given avatar.

    `max_tiles_per_gaussian` must cover the window the TRAINER ended on
    (adaptive escalation): rendering with a smaller window clips the large
    gaussians the training loss depended on.

    `large_frac` defaults to 1.0 — UNLIKE training.  The trainer's 0.125
    budget is a fraction of its (mostly dead) fixed CAPACITY and is guarded
    by runtime spill escalation; a loaded point cloud is compact (all
    alive), so a fractional budget here silently pushed up to ~80% of the
    gaussians through the clipped 2x2 small window (measured −10 dB on the
    512^2 e2e case).  Exports render each frame once, so the extra sort
    pairs are cheap; never spill.

    `n_tile` > 1 rasterizes each frame spatially sharded over a `tile`
    device-mesh axis (parallel.shard.rasterize_tile_sharded): tiles are
    independent, so the only collective is the final image all_gather."""
    bg_value = 1.0 if white_background else 0.0
    ds = FrameDataset(data_dir, split=split)
    out_renders = Path(out_renders)
    out_renders.mkdir(parents=True, exist_ok=True)
    if out_gt is not None:
        Path(out_gt).mkdir(parents=True, exist_ok=True)
    T = len(ds)
    if T == 0:
        return out_renders

    # ONE batched, jitted FLAME forward for all frames (a per-frame eager
    # forward dominated the render stage's wall time)
    per_frame = [ds.load_frame_params(i) for i in range(T)]
    batched = {}
    for k in per_frame[0]:
        if k == "dynamic_offset":
            continue
        if k == "shape" or k == "static_offset":
            batched[k] = jnp.asarray(per_frame[0][k])
        else:
            batched[k] = jnp.asarray(
                np.concatenate([np.atleast_2d(p[k]) for p in per_frame]))
    verts_all = jax.jit(lambda p: flame_forward(flame_model, p))(batched)

    cam0 = ds.camera(0)
    W, H = cam0.width, cam0.height

    bg_arr = jnp.full((3,), bg_value, jnp.float32)
    tile_mesh = None
    if n_tile > 1:
        from jax.sharding import Mesh
        devs = jax.devices()
        if len(devs) < n_tile:
            raise RuntimeError(f"parallel.n_tile={n_tile} but only "
                               f"{len(devs)} devices")
        tile_mesh = Mesh(np.asarray(devs[:n_tile]), ("tile",))

    @jax.jit
    def render_one(g, v, w2c, fx, fy, cx, cy):
        from omfs4d.ops.camera import Camera
        c = Camera(w2c=w2c, fx=fx, fy=fy, cx=cx, cy=cy, width=W, height=H)
        if tile_mesh is not None:
            from omfs4d.models.gaussians import bind_to_mesh, eval_colors
            from omfs4d.parallel.shard import rasterize_tile_sharded
            means, rot, scales, opac, _ = bind_to_mesh(
                g, v, flame_model.faces)
            cam_pos = -c.w2c[:3, :3].T @ c.w2c[:3, 3]
            cols = eval_colors(g, means, cam_pos)
            img, _ = rasterize_tile_sharded(
                means, rot, scales, opac, cols, c, W, H,
                mesh=tile_mesh, axis="tile", background=bg_arr,
                max_per_tile=max_per_tile,
                max_tiles_per_gaussian=max(36, max_tiles_per_gaussian))
            return img
        img, _ = render_avatar_frame(
            g, v, flame_model.faces, c, W, H,
            background=bg_arr,
            backend=backend, max_per_tile=max_per_tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            large_frac=large_frac,
        )
        return img

    # Pipelined loop: JAX dispatch is async, so keeping a small window of
    # in-flight frames overlaps device rasterization with host PNG encode +
    # D2H transfers.  (Batching frames through vmap was measured slower:
    # batched lax.sort/gather lowerings underperform their unbatched forms
    # — see the B==1 note in train/trainer.py.)
    window = 4
    pending: list[tuple[int, object]] = []

    def _drain(entry):
        i, img = entry
        name = Path(ds.frame_meta(i)["file_path"]).name
        write_image(out_renders / name, np.asarray(img))
        if out_gt is not None:
            # GT must match the training target: when fg_masks exist the
            # trainer composites frames over the CONFIGURED background (the
            # trainer's self.bg), and the renders use the same background
            # (GaussianAvatars stores the same masked gt in train/ours_N/gt)
            gt = ds.load_image(i).astype(np.float32) / 255.0
            m = ds.load_mask(i)
            if m is not None:
                gt = gt * m[..., None] + bg_value * (1.0 - m[..., None])
            write_image(Path(out_gt) / name, gt)

    for i in range(T):
        cam = ds.camera(i)
        img = render_one(gaussians, verts_all[i], cam.w2c, cam.fx, cam.fy,
                         cam.cx, cam.cy)
        pending.append((i, img))
        if len(pending) >= window:
            _drain(pending.pop(0))
    for entry in pending:
        _drain(entry)
    return out_renders


def render_prediction(
    model_dir: str | Path,
    data_dir: str | Path,
    flame_model: FlameModel,
    output: str | Path | None = "final_prediction.mp4",
    lefort_mm: float = 0.0,
    bsso_mm: float = 0.0,
    sensitivity: float = 1.0,
    fps: int = 30,
    iteration: int = -1,
    rig_mode: str = "flame_only",
    canonical_head_asset: str = "",
    deformation_map: str = "",
    export_frames_dir: str = "",
    deterministic_indices: str = "",
    deterministic_max_frames: int = 24,
    backend: str = "auto",
    keep_modified_dataset: bool = False,
    white_background: bool = True,
    n_tile: int = 1,
    max_per_tile: int = 512,
) -> dict:
    """Full prediction pipeline: offsets -> modified dataset -> render -> MP4.

    `output=None` stops at the rendered PNG frames (no video encoder
    needed)."""
    lefort_offset = compute_offset(lefort_mm, sensitivity)
    bsso_offset = compute_offset(bsso_mm, sensitivity)
    effective_mode, mode_reason = choose_rig_mode(rig_mode, canonical_head_asset)
    deform = load_deformation_map(
        deformation_map if effective_mode == "hybrid_full_head" else None
    )
    log.info(f"Le Fort: {lefort_mm} mm -> offset {lefort_offset:.6f}")
    log.info(f"BSSO:    {bsso_mm} mm -> offset {bsso_offset:.6f}")
    log.info(f"Rig mode: {effective_mode} ({mode_reason})")

    model_dir = Path(model_dir)
    it = iteration if iteration > 0 else latest_iteration(model_dir)
    if it is None:
        raise FileNotFoundError(f"No point_cloud/iteration_* in {model_dir}")
    pc_path = model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"
    gaussians = load_point_cloud(pc_path)
    log.info(f"Using iteration: {it} ({int(gaussians.alive.sum())} gaussians)")

    # render with (at least) the tile window the trainer escalated to —
    # a smaller window would clip the large gaussians the training loss
    # optimized through (checkpoints/iter_*_meta.json)
    from omfs4d.train.checkpoints import trained_render_meta
    meta = trained_render_meta(model_dir, it)
    window = max(16, int(meta.get("max_tiles_per_gaussian", 0)) or 16)
    if window > 16:
        log.info(f"render window: max_tiles_per_gaussian={window} "
                 f"(from training meta)")
    if meta.get("max_per_tile"):
        # composite with the trainer's per-tile capacity: larger K exposes
        # depth-tail gaussians the loss never supervised (-6 dB measured),
        # smaller K clips content the loss relied on
        max_per_tile = int(meta["max_per_tile"])
        log.info(f"render per-tile capacity: max_per_tile={max_per_tile} "
                 f"(from training meta)")

    # clear stale renders (parity: render_surgery.py:260-267)
    train_dir = model_dir / "train"
    if train_dir.is_dir():
        for d in train_dir.iterdir():
            renders = d / "renders"
            if renders.is_dir():
                shutil.rmtree(renders)

    refined = model_dir / "flame_param_refined.npz"
    if refined.exists():
        log.info("using co-optimized FLAME params from training")
    modified = create_modified_dataset(
        str(data_dir), lefort_offset, bsso_offset, deformation_map=deform,
        refined_params=str(refined) if refined.exists() else None)
    try:
        renders_dir = train_dir / f"ours_{it}" / "renders"
        gt_dir = train_dir / f"ours_{it}" / "gt"
        render_dataset_frames(
            flame_model, gaussians, modified, renders_dir, out_gt=gt_dir,
            split="train", backend=backend, white_background=white_background,
            max_tiles_per_gaussian=window, n_tile=n_tile,
            max_per_tile=max_per_tile,
        )

        if export_frames_dir:
            export_deterministic_frames(
                str(renders_dir), export_frames_dir,
                index_file=deterministic_indices or None,
                max_frames=deterministic_max_frames,
            )

        out_path = None
        if output is not None:
            out_path = str(stitch_video(renders_dir, output, fps=fps))
            log.info(f"Video saved to {out_path}")
        return {
            "video": out_path,
            "renders_dir": str(renders_dir),
            "iteration": it,
            "rig_mode": effective_mode,
            "lefort_offset": lefort_offset,
            "bsso_offset": bsso_offset,
        }
    finally:
        if not keep_modified_dataset:
            shutil.rmtree(modified, ignore_errors=True)
